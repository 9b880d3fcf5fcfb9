"""Benchmark harness: the device a number was taken on, and timing.

Every record a benchmark writes names the device it ran on: JAX's
``platform``, ``device_kind`` and device count, and the card's name and
power limit as ``nvidia-smi`` reports them (a card set below its maximum
power runs slower under load, so a time means little without it).  A
measurement that finds no GPU fails; it never falls back to the CPU.

``run`` ports the reference's wall-clock policy (``src/bench.{h,c}``):
trials double in size until one takes at least TARGET_TRIAL seconds or
the budget MAX_TOTAL is spent (bench.h:6-7, bench.c:37-49); throughput
is bytes per second of processed data.  Each trial ends in
``block_until_ready``, since JAX returns before the device finishes.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Callable, List

import jax

TARGET_TRIAL_S = 0.5  # bench.h:6
MAX_TOTAL_S = 30.0  # bench.h:7

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def card_lines() -> List[str]:
    """One ``name, power limit`` line per card, from ``nvidia-smi`` run as
    a child process that stays off JAX; a one-line explanation when the
    tool is missing or fails."""
    try:
        r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return [f"nvidia-smi unavailable ({type(exc).__name__})"]
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode != 0 or not lines:
        return [f"nvidia-smi failed (exit {r.returncode})"]
    return lines


def card_tag() -> str:
    """The first card's ``name, power limit``, to print beside times."""
    return card_lines()[0]


def require_gpu():
    """The first JAX device, or ``SystemExit`` when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on the card")
    return dev


def device_record() -> dict:
    """The device fields every benchmark record carries."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "card": card_tag()}


@dataclass
class Result:
    bytes_per_second: float
    iterations: int
    trial_seconds: float

    @property
    def gb_per_second(self) -> float:
        return self.bytes_per_second / 1e9


def run(fn: Callable[[object], object], bytes_per_iter: int,
        target_trial_s: float = TARGET_TRIAL_S,
        max_total_s: float = MAX_TOTAL_S) -> Result:
    """Benchmark ``fn(salt)``.

    ``fn`` takes a uint32 scalar jax array that must feed into its
    computation (e.g. XOR into an RNG key); each iteration's salt is
    derived from the previous output and a counter, so no two calls see
    the same inputs and none can be skipped as dead code.  The first call
    (compilation) and one second of burn-in are excluded; the result is
    the median of three trials at the final size.
    """
    import jax.numpy as jnp

    iter_count = 0

    def derive_salt(out):
        nonlocal iter_count
        iter_count += 1
        v = jax.tree.leaves(out)[0].ravel()[0]
        if v.dtype == jnp.float32:
            v = jax.lax.bitcast_convert_type(v, jnp.uint32)
        elif v.dtype != jnp.uint32:
            v = v.astype(jnp.float32).astype(jnp.int32).astype(jnp.uint32)
        return v ^ jnp.uint32(iter_count)

    salt = jnp.uint32(0)
    out = fn(salt)
    jax.block_until_ready(out)
    t_burn = time.perf_counter()
    while time.perf_counter() - t_burn < 1.0:
        out = fn(salt)
        salt = derive_salt(out)
    jax.block_until_ready(out)

    def trial(iters):
        nonlocal salt
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(salt)
            salt = derive_salt(out)
        jax.block_until_ready((out, salt))
        return time.perf_counter() - t0

    start_total = time.perf_counter()
    iters = 1
    while True:
        dt = trial(iters)
        elapsed = time.perf_counter() - start_total
        if dt >= target_trial_s or elapsed + dt * 4 > max_total_s:
            break
        iters *= 2
    samples = [dt]
    while len(samples) < 3 and \
            time.perf_counter() - start_total + dt <= max_total_s:
        samples.append(trial(iters))
    dt = sorted(samples)[len(samples) // 2]
    return Result(bytes_per_second=bytes_per_iter * iters / dt,
                  iterations=iters, trial_seconds=dt)
