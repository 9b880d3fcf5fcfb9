#!/usr/bin/env python
"""Proof that the codec's main path runs on an NVIDIA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded phase only

One card drives the user's entry points over a 512^3-particle N-body
snapshot (134,217,728 particles of positions, velocities and IDs, the
particle count of a standard 512^3 Gadget-2 run; 32 B per particle,
4.3 GB raw), generated from ``--seed`` as a displaced lattice:

  device       the first JAX device is a GPU; card name and power limit
  numerics     f32 division (XLA's and kernels.exact_div) and the bin
               map against IEEE/numpy, the Threefry dither against its
               numpy mirror, bit packing against the native host oracle
               (widths 1-32, ragged tails)
  wire         every frozen digest in tests/fixtures/wire_digests.json
               encodes to the same bytes on the card; decodes lie within
               delta and within one rounding of the strict per-op numpy
               oracle
  snapshot     compress_snapshot / decompress_snapshot (16 segments of
               2^23 particles), cold and warm, positions-only and
               spatial sub-box reads, deterministic decode, and the same
               file encoded on the CPU backend byte for byte
  delta        one segment's positions through Coil v1.1, Octo v1.1 and
               Sort v1.2: card bytes == CPU bytes, round trip in delta

Four cards run ShardedSnapshotCodec over a 4-device mesh (64 blocks of
2^21 particles) against the same codec on one device, and read a file
back with decompress_snapshot_multihost.

Every time is printed with the card's name and power limit.  The last
line of standard output is one JSON object; the exit code is 0 only when
every phase passed, and the script refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GRID = 512             # particles per side: 512^3 = 134,217,728
BOX = 100.0            # periodic box width
NUM_BLOCKS = 16        # 2^23 particles per segment (< 10^7, 32-aligned)
SHARDED_BLOCKS = 64    # 2^21 particles per block on the four-card mesh
POS_DELTA = 1e-3
VEL_DELTA = 1.0
VEL_SIGMA = 300.0
DISPLACEMENT = 0.3     # Gaussian displacement, in lattice cells


def say(phase: str, msg: str, tag: str = "") -> None:
    """One progress line; ``tag`` (card name, power limit) goes beside
    every time."""
    print(f"[chip_smoke] {phase}: {msg}" + (f" | {tag}" if tag else ""),
          flush=True)


def timed(fn, *args, **kwargs):
    """(result, seconds) with the result's device work finished."""
    import jax
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def profiled_spans(sink: list):
    """Collect the ``[minnow] <phase>: <ms>`` lines that
    ``utils.profiling.phase`` prints under MINNOW_PROFILE."""
    old = os.environ.get("MINNOW_PROFILE")
    os.environ["MINNOW_PROFILE"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        if old is None:
            del os.environ["MINNOW_PROFILE"]
        else:
            os.environ["MINNOW_PROFILE"] = old
        sink.extend(ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("[minnow]"))


def periodic_err(a, b, box: float) -> float:
    """Largest periodic distance between two (3, n) f32 arrays, in f64."""
    worst = 0.0
    for d in range(a.shape[0]):
        e = np.abs(a[d].astype(np.float64) - b[d].astype(np.float64))
        worst = max(worst, float(np.minimum(e, box - e).max(initial=0.0)))
    return worst


def abs_err(a, b) -> float:
    worst = 0.0
    for d in range(a.shape[0]):
        e = np.abs(a[d].astype(np.float64) - b[d].astype(np.float64))
        worst = max(worst, float(e.max(initial=0.0)))
    return worst


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def make_snapshot(grid: int, seed: int, box: float = BOX):
    """Displaced lattice: positions are lattice sites of a periodic box
    plus Gaussian displacements of DISPLACEMENT cells, wrapped into the
    box; velocities Gaussian with sigma VEL_SIGMA; IDs the lattice index
    in ID order (x fastest).  Returns pos (3, n) f32, vel (3, n) f32,
    ids (n,) u64."""
    n = grid ** 3
    rng = np.random.default_rng(seed)
    cell = np.float32(box / grid)
    boxf = np.float32(box)
    ids = np.arange(n, dtype=np.uint64)
    pos = np.empty((3, n), np.float32)
    lattice = np.arange(grid, dtype=np.float32) * cell
    shape = (grid, grid, grid)          # (z, y, x) with x fastest
    for d in range(3):
        site = np.broadcast_to(
            lattice.reshape([grid if k == 2 - d else 1 for k in range(3)]),
            shape).reshape(-1)
        x = site + rng.standard_normal(n, dtype=np.float32) * \
            np.float32(DISPLACEMENT * cell)
        x = np.where(x < 0, x + boxf, x)
        pos[d] = np.where(x >= boxf, x - boxf, x)
    vel = rng.standard_normal((3, n), dtype=np.float32) * \
        np.float32(VEL_SIGMA)
    return pos, vel, ids


def snapshot_spec(grid: int):
    import minnow_c_tpu as mnw
    from minnow_c_tpu.parallel.snapshot import SnapshotSpec
    return SnapshotSpec(pos=mnw.PositionAccuracy(delta=POS_DELTA, width=BOX),
                        vel=mnw.VelocityAccuracy(delta=VEL_DELTA),
                        ids=mnw.IDAccuracy(width=grid))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(tag: str) -> dict:
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    say("device", f"{info['kind']} x{info['count']} ({info['platform']}), "
        f"jax {jax.__version__}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from minnow_c_tpu.bench import harness
    for line in harness.card_lines():
        say("device", f"card: {line}")
    return info


def _bins_oracle(x, level: int, x0, dx):
    """The C-exact division bin map (util.c:173-196) in numpy f32."""
    with np.errstate(invalid="ignore", divide="ignore"):
        delta = (x - np.float32(x0)) / np.float32(dx)
        nb = np.float32(1 << level)
        scaled = (delta * nb).astype(np.float64)
    top = (1 << level) - 1
    out = np.where(delta < 0, 0, np.where(
        delta >= 1, top, np.nan_to_num(scaled).astype(np.int64)))
    return np.where(np.isnan(delta), 0, out).astype(np.uint32)


def phase_numerics(n_div: int = 1 << 22, n_pack: int = (1 << 16) + 37,
                   widths=range(1, 33), seed: int = 0) -> dict:
    """Arithmetic the wire depends on, computed on the default device."""
    import jax
    import jax.numpy as jnp

    from minnow_c_tpu.ops import bitpack, kernels, native
    from minnow_c_tpu.ops import rng as _rng

    rng = np.random.default_rng(seed)
    out = {}

    # f32 division: XLA's own divide, kernels.exact_div and the bin map
    # against IEEE numpy
    xs = rng.uniform(0, 64, n_div).astype(np.float32)
    div = jax.jit(lambda a, b: a / b)
    exact = jax.jit(kernels.exact_div)
    raw_bad = exact_bad = bin_bad = 0
    for dv in (63.99731, 3.14159, 7.77e-7, 1.23456e8):
        d = np.float32(dv)
        ref = xs / d
        xd = jnp.asarray(xs)
        got = np.asarray(div(xd, jnp.float32(d)))
        raw_bad += int(((ref != got) & np.isfinite(ref)).sum())
        got = np.asarray(exact(xd, jnp.float32(d)))
        exact_bad += int(((ref != got) & np.isfinite(ref)).sum())
        level = 14
        gb = np.asarray(jax.jit(kernels.uniform_bin_index,
                                static_argnums=1)(
            xd, level, jnp.float32(0.0), jnp.float32(d)))
        bin_bad += int((gb != _bins_oracle(xs, level, 0.0, d)).sum())
    # quotients in the subnormal range show a flush to zero; a bin index
    # never depends on one (a subnormal quotient bins to 0 either way)
    tiny = (rng.uniform(1, 2, n_div) * 1e-31).astype(np.float32)
    dd = np.float32(1.23456e8)
    sub_got = np.asarray(div(jnp.asarray(tiny), jnp.float32(dd)))
    with jax.default_device(jax.devices("cpu")[0]):
        sub_cpu = np.asarray(div(jnp.asarray(tiny), jnp.float32(dd)))
    sub_ieee = int(((tiny / dd).view(np.uint32) !=
                    sub_got.view(np.uint32)).sum())
    sub_vs_cpu = int((sub_cpu.view(np.uint32) !=
                      sub_got.view(np.uint32)).sum())
    out["div_raw_mismatches"] = raw_bad
    out["div_exact_mismatches"] = exact_bad
    out["div_bin_mismatches"] = bin_bad
    out["div_subnormal_vs_ieee"] = sub_ieee
    out["div_subnormal_vs_cpu"] = sub_vs_cpu
    say("numerics", f"f32 divide vs IEEE: XLA's {raw_bad} and "
        f"kernels.exact_div's {exact_bad} of {4 * n_div} quotients differ; "
        f"bin map vs numpy: {bin_bad} differ; of "
        f"{n_div} subnormal quotients {sub_ieee} differ from IEEE and "
        f"{sub_vs_cpu} from the CPU backend")

    # Threefry dither vector vs its numpy mirror
    key = (np.uint32(0xDEADBEEF), np.uint32(0x12345678))
    nd = 40003
    dev = np.asarray(jax.jit(lambda: _rng.dither_u16(key, nd, ctr0=4096))())
    dref = _rng.dither_u16_np(key, nd, ctr0=4096)
    fk = np.asarray(_rng.field_key_arr(777, 3, 1))
    fk_ref = np.asarray(_rng.field_key(777, 3, 1), dtype=np.uint32)
    out["dither_mismatches"] = int((dev != dref).sum()) + \
        int((fk != fk_ref).sum())
    say("numerics", f"dither: {out['dither_mismatches']} of {nd} lanes "
        "differ from the numpy mirror")

    # bit packing vs the native host oracle
    pack_bad = []
    rows, n_rows = 3, (n_pack // 32) * 32
    for w in widths:
        vals = rng.integers(0, 1 << w, n_pack, dtype=np.uint64).astype(
            np.uint32)
        want = native.uniform_pack_host(vals, w)
        words = bitpack.uniform_pack(jnp.asarray(vals), w)
        back = bitpack.uniform_unpack(words, w, n_pack)
        rv = rng.integers(0, 1 << w, (rows, n_rows),
                          dtype=np.uint64).astype(np.uint32)
        got_rows = np.asarray(bitpack.uniform_pack_rows(jnp.asarray(rv), w))
        rows_ok = all(np.array_equal(got_rows[r],
                                     native.uniform_pack_host(rv[r], w))
                      for r in range(rows))
        if not (np.array_equal(np.asarray(words), want) and
                np.array_equal(np.asarray(back), vals) and rows_ok):
            pack_bad.append(w)
    out["pack_bad_widths"] = pack_bad
    say("numerics", f"pack/unpack/pack_rows vs native at widths "
        f"{min(widths)}-{max(widths)} (n={n_pack}): "
        + ("all equal" if not pack_bad else f"DIFFER at {pack_bad}"))

    problems = []
    if exact_bad:
        problems.append(f"{exact_bad} kernels.exact_div quotients differ "
                        "from IEEE")
    if bin_bad:
        problems.append(f"{bin_bad} bin indices differ from the C-exact map")
    if out["dither_mismatches"]:
        problems.append("dither differs from its numpy mirror")
    if pack_bad:
        problems.append(f"bit packing differs at widths {pack_bad}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def _wire_cases(names=None):
    """(name, segment, seed) for every entry of the frozen-digest fixture,
    built by the same functions that wrote it."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_freeze as tf
    cases = [(k, tf.deltas_segment(*v), 888)
             for k, v in tf.DELTAS_ALGOS.items()]
    cases += [(k, tf.reference_segment(*v), 777) for k, v in tf.ALGOS.items()]
    cases.append(("sort_v1_2_orderfree", tf.orderfree_segment(), 777))
    if names is not None:
        cases = [c for c in cases if c[0] in names]
    with open(tf.FIXTURE) as f:
        return cases, json.load(f)


def _oracle_floats(qf, field_index: int):
    """Strict per-op f32 reconstruction (numpy) of a float QField from the
    stream's bins, the numpy dither mirror and the undo formula, one
    rounding per operation.  Returns (values, magnitudes): a backend that
    contracts x0 + dx*t into an FMA may differ from a value by one
    rounding at its magnitude, the largest of |dx*t|, |x0 + dx*t| and
    the value after the periodic wrap."""
    from minnow_c_tpu.ops import rng as rng_mod
    from minnow_c_tpu.types import FieldCode
    q = qf.quant

    def scale(rng_f32):
        if q.depths is None:
            return np.float32(rng_f32 / np.float32(1 << q.depth))
        p2 = (np.int64(1) << np.asarray(q.depths).astype(np.int64))
        return (rng_f32 / p2.astype(np.float32)).astype(np.float32)

    if qf.hd.field_code == int(FieldCode.UNSF):
        bins = np.asarray(qf.data).reshape(-1)
        u = rng_mod.uniform24_np(rng_mod.field_key(q.seed, field_index, 0),
                                 bins.shape)
        prod = scale(np.float32(q.x1) - np.float32(q.x0)) * (
            bins.astype(np.float32) + u)
        y = np.float32(q.x0) + prod
        return y, np.maximum(np.abs(prod), np.abs(y))
    x0a = np.asarray(q.x0, np.float32)
    x1a = np.asarray(q.x1, np.float32)
    md = np.float32(np.max(x1a - x0a))
    bins = np.asarray(qf.data).reshape(3, -1)
    dims, mags = [], []
    for d in range(3):
        u = rng_mod.uniform24_np(rng_mod.field_key(q.seed, field_index, d),
                                 bins[d].shape)
        prod = scale(np.float32(x0a[d] + md) - x0a[d]) * (
            bins[d].astype(np.float32) + u)
        y = x0a[d] + prod
        mag = np.maximum(np.abs(prod), np.abs(y))
        if qf.hd.field_code == int(FieldCode.POSN):
            w = np.float32(q.width)
            y = np.where(y >= w, y - w, y)
            y = np.where(y < 0, y + w, y)
        mags.append(np.maximum(mag, np.abs(y)))
        dims.append(np.float32(y))
    return np.stack(dims), np.stack(mags)


def phase_wire(names=None, tag: str = "") -> dict:
    """Frozen digests encoded on the default device; decodes checked
    against the data (delta) and the strict numpy oracle."""
    from minnow_c_tpu.segment import api
    from minnow_c_tpu.types import FieldCode

    cases, want = _wire_cases(names)
    bad_digest, over_delta, over_ulp = [], [], []
    n_off = 0
    n_floats = 0
    t0 = time.perf_counter()
    for name, seg, seed in cases:
        blob = api.compress_segment(seg, seed=seed)
        if hashlib.sha256(blob).hexdigest() != want[f"{name}_encode_sha256"]:
            bad_digest.append(name)
        dec = api.decompress_segment(blob)
        qs = api.decompress(api.wire_to_cseg(blob))
        for fi, (src, got, qf) in enumerate(zip(seg.fields, dec.fields,
                                                qs.fields)):
            code = src.hd.field_code
            g = np.asarray(got.data)
            data = np.asarray(src.data)
            if code in (FieldCode.PTID, FieldCode.UNSI):
                ref = np.sort(data) if name.endswith("orderfree") else data
                if not np.array_equal(g.reshape(-1), ref.reshape(-1)):
                    over_delta.append(f"{name}:{fi}")
                continue
            acc = src.acc
            delta = acc.deltas if acc.deltas is not None else acc.delta
            if code == FieldCode.POSN:
                e = np.abs(g.astype(np.float64) - data)
                e = np.minimum(e, acc.width - e)
            else:
                e = np.abs(g.astype(np.float64) - data)
            if not np.all(e <= delta):
                over_delta.append(f"{name}:{fi}")
            ref, mag = _oracle_floats(qf, fi)
            diff = np.abs(g.astype(np.float64) - ref)
            if code == FieldCode.POSN:
                diff = np.minimum(diff, acc.width - diff)
            tol = np.spacing(mag)
            n_floats += diff.size
            n_off += int((diff > 0).sum())
            if np.any(diff > tol):
                over_ulp.append(f"{name}:{fi}")
    dt = time.perf_counter() - t0
    say("wire", f"{len(cases)} frozen streams: "
        f"{len(cases) - len(bad_digest)} encode digests equal; decodes: "
        f"{n_off} of {n_floats} floats differ from the strict per-op oracle, "
        "each by at most one rounding of dx*t (tolerance: XLA may contract "
        "x0 + dx*t into an FMA), "
        f"{len(over_delta)} fields out of delta; {dt:.1f} s incl. "
        "compilation", tag)
    problems = []
    if bad_digest:
        problems.append(f"encode digests differ: {bad_digest}")
    if over_delta:
        problems.append(f"decodes out of delta / not exact: {over_delta}")
    if over_ulp:
        problems.append("decodes differ from the oracle by more than one "
                        f"rounding of dx*t: {over_ulp}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"streams": len(cases), "off": n_off, "floats": n_floats}


def _segments(path_or_buf):
    from minnow_c_tpu.segment import io as seg_io
    if isinstance(path_or_buf, (bytes, bytearray)):
        return [b for _, b in seg_io.iter_segments(io.BytesIO(path_or_buf))]
    with open(path_or_buf, "rb") as f:
        return [b for _, b in seg_io.iter_segments(f)]


def phase_snapshot(pos, vel, ids, grid: int, num_blocks: int, seed: int,
                   tag: str = "", workdir: str = None) -> dict:
    """compress_snapshot / decompress_snapshot through a file, cold and
    warm, plus the partial reads and the CPU-backend byte check."""
    import jax

    from minnow_c_tpu.parallel import snapshot

    n = ids.shape[0]
    nb = n // num_blocks
    spec = snapshot_spec(grid)
    res = {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        path = os.path.join(tmp, "snap.min")

        def write():
            with open(path, "wb") as f:
                return snapshot.compress_snapshot(f, pos, vel, ids, spec,
                                                  num_blocks, seed=seed)

        def read(**kw):
            with open(path, "rb") as f:
                return snapshot.decompress_snapshot(f, **kw)

        stats, t_enc_cold = timed(write)
        out1, t_dec_cold = timed(read)
        enc_spans, dec_spans = [], []
        with profiled_spans(enc_spans):
            _, t_enc = timed(write)
        with profiled_spans(dec_spans):
            out2, t_dec = timed(read)
        size = os.path.getsize(path)
        res.update(encode_cold_s=t_enc_cold, decode_cold_s=t_dec_cold,
                   encode_s=t_enc, decode_s=t_dec, bytes=size,
                   depths=(stats["pos_depth"], stats["vel_depth"],
                           stats["id_widths"]))
        say("snapshot", f"{n} particles, {num_blocks} segments, {size} B "
            f"({size / n:.2f} B/particle), depths pos {stats['pos_depth']} "
            f"vel {stats['vel_depth']} ids {stats['id_widths']}")
        say("snapshot", f"compress_snapshot cold {t_enc_cold:.3f} s, warm "
            f"{t_enc:.3f} s ({32 * n / t_enc / 1e9:.2f} GB/s raw)", tag)
        say("snapshot", f"decompress_snapshot cold {t_dec_cold:.3f} s, warm "
            f"{t_dec:.3f} s ({32 * n / t_dec / 1e9:.2f} GB/s raw)", tag)
        for ln in enc_spans + dec_spans:
            say("snapshot", "span " + ln[len("[minnow] "):], tag)

        e_pos = periodic_err(out1["pos"], pos, BOX)
        e_vel = abs_err(out1["vel"], vel)
        ids_ok = np.array_equal(out1["ids"], ids)
        same = all(np.array_equal(out1[k].view(np.uint32)
                                  if out1[k].dtype == np.float32
                                  else out1[k], out2[k].view(np.uint32)
                                  if out2[k].dtype == np.float32
                                  else out2[k]) for k in out1)
        res.update(pos_err=e_pos, vel_err=e_vel)
        say("snapshot", f"max error pos {e_pos:.3e} (delta {POS_DELTA}), "
            f"vel {e_vel:.3e} (delta {VEL_DELTA}); IDs "
            f"{'bit-exact' if ids_ok else 'DIFFER'}; two decodes "
            f"{'identical' if same else 'DIFFER'}")

        only, t_pos = timed(read, fields={"pos"})
        pos_only_ok = set(only) == {"pos"} and np.array_equal(
            only["pos"].view(np.uint32), out1["pos"].view(np.uint32))
        q_origin, q_width = (0.0, 0.0, 0.4 * BOX), (BOX, BOX, 0.05 * BOX)
        sub, t_box = timed(read, box=(q_origin, q_width), periodic=BOX)
        m = sub["ids"].shape[0] if sub else 0
        box_ok = 0 < m < n and m % nb == 0
        for k in range(m // nb if box_ok else 0):
            b = int(sub["ids"][k * nb]) // nb
            sl = slice(b * nb, (b + 1) * nb)
            box_ok &= np.array_equal(sub["ids"][k * nb:(k + 1) * nb],
                                     ids[sl]) and np.array_equal(
                sub["pos"][:, k * nb:(k + 1) * nb].view(np.uint32),
                out1["pos"][:, sl].view(np.uint32))
        say("snapshot", f"positions-only read {t_pos:.3f} s "
            f"({'equal' if pos_only_ok else 'DIFFERS'}); sub-box read "
            f"{t_box:.3f} s, {m // nb if nb else 0} of {num_blocks} "
            f"segments ({'equal' if box_ok else 'DIFFERS'})", tag)

        t0 = time.perf_counter()
        buf = io.BytesIO()
        with jax.default_device(jax.devices("cpu")[0]):
            snapshot.compress_snapshot(buf, pos, vel, ids, spec, num_blocks,
                                       seed=seed)
        t_cpu = time.perf_counter() - t0
        card_segs = _segments(path)
        cpu_segs = _segments(buf.getvalue())
        equal = sum(a == b for a, b in zip(card_segs, cpu_segs))
        seg0_ok = bool(card_segs) and card_segs[0] == cpu_segs[0]
        say("snapshot", f"CPU-backend encode {t_cpu:.1f} s: segment 0 "
            f"{'byte-equal' if seg0_ok else 'DIFFERS'}; {equal} of "
            f"{len(card_segs)} segments byte-equal")

    dev = jax.devices()[0]
    stats_mem = dev.memory_stats() or {}
    peak = stats_mem.get("peak_bytes_in_use")
    res["peak_bytes"] = peak
    say("snapshot", "device peak memory "
        + (f"{peak / 2**30:.2f} GiB" if peak is not None else "not reported"))
    problems = [msg for ok, msg in (
        (e_pos <= POS_DELTA, f"position error {e_pos}"),
        (e_vel <= VEL_DELTA, f"velocity error {e_vel}"),
        (ids_ok, "IDs differ"), (same, "two decodes differ"),
        (pos_only_ok, "positions-only read differs"),
        (box_ok, "sub-box read differs"),
        (seg0_ok, "segment 0 differs from the CPU-backend encode"),
        (equal == len(card_segs), "CPU-backend segments differ"))
        if not ok]
    if problems:
        raise AssertionError("; ".join(problems))
    return res


def phase_delta_family(pos_block, seed: int, tag: str = "") -> dict:
    """One segment's positions through the chunked-delta codecs: the
    card's bytes equal the CPU backend's, the round trip is in delta."""
    import jax

    import minnow_c_tpu as mnw
    from minnow_c_tpu import semver
    from minnow_c_tpu.segment import api

    n = pos_block.shape[1]
    res = {}
    problems = []
    for name, algo, ver in (("Coil v1.1", mnw.AlgoCode.COIL, (1, 1, 0)),
                            ("Octo v1.1", mnw.AlgoCode.OCTO, (1, 1, 0)),
                            ("Sort v1.2", mnw.AlgoCode.SORT, (1, 2, 0))):
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, semver.pack(*ver),
                               n),
            data=pos_block,
            acc=mnw.PositionAccuracy(delta=POS_DELTA, width=BOX))])
        blob, t_enc = timed(api.compress_segment, seg, seed=seed)
        with jax.default_device(jax.devices("cpu")[0]):
            blob_cpu = api.compress_segment(seg, seed=seed)
        dec, t_dec = timed(lambda: np.asarray(api.decompress_segment(
            blob, fused=True).fields[0].data))
        err = periodic_err(dec, pos_block, BOX)
        same = blob == blob_cpu
        res[name] = {"bytes": len(blob), "encode_s": t_enc,
                     "decode_s": t_dec, "err": err}
        say("delta", f"{name}: {n} positions -> {len(blob)} B, encode "
            f"{t_enc:.3f} s, decode {t_dec:.3f} s (first call, incl. "
            f"compilation), max error {err:.3e}, CPU bytes "
            f"{'equal' if same else 'DIFFER'}", tag)
        if not same:
            problems.append(f"{name} bytes differ from the CPU backend")
        if err > POS_DELTA:
            problems.append(f"{name} error {err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return res


def phase_four_cards(pos, vel, ids, grid: int, seed: int, tag: str = "",
                     num_blocks: int = SHARDED_BLOCKS, cards: int = 4,
                     workdir: str = None) -> dict:
    """ShardedSnapshotCodec over a ``cards``-device mesh against the same
    codec on one device, and the multihost reader over that mesh."""
    import jax
    from jax.sharding import Mesh

    from minnow_c_tpu.parallel import snapshot
    from minnow_c_tpu.parallel.sharding import (ShardedSnapshotCodec,
                                                make_mesh, spmd_depth_for)
    from minnow_c_tpu.quant.engine import delta_to_depth

    if len(jax.devices()) < cards:
        raise AssertionError(f"{cards} devices needed, "
                             f"{len(jax.devices())} found")
    n = ids.shape[0]
    nb = n // num_blocks
    pos_b = np.ascontiguousarray(
        np.moveaxis(pos.reshape(3, num_blocks, nb), 1, 0))
    vel_b = np.ascontiguousarray(
        np.moveaxis(vel.reshape(3, num_blocks, nb), 1, 0))
    ids_b = ids.reshape(num_blocks, nb)
    pos_depth = spmd_depth_for(POS_DELTA, BOX)
    vel_depth = delta_to_depth(VEL_DELTA, float(vel.min()), float(vel.max()))
    res = {}
    outs = {}
    for k in (cards, 1):
        codec = ShardedSnapshotCodec(mesh=make_mesh(k), box=BOX,
                                     pos_depth=pos_depth,
                                     vel_depth=vel_depth, id_grid=grid)
        sh = codec._in_shardings()
        args = (jax.device_put(pos_b.reshape(-1, nb), sh),
                jax.device_put(vel_b.reshape(-1, nb), sh),
                jax.device_put(ids_b, sh))
        enc, t_cold = timed(codec.encode, *args)
        _, t_enc = timed(codec.encode, *args)
        dec, t_dcold = timed(codec.decode, enc, seed)
        _, t_dec = timed(codec.decode, enc, seed)
        outs[k] = ([np.asarray(a) for a in enc], [np.asarray(a) for a in dec])
        res[k] = {"encode_s": t_enc, "decode_s": t_dec}
        say("four_cards", f"ShardedSnapshotCodec on {k} device(s): encode "
            f"{t_enc:.4f} s (cold {t_cold:.2f} s), decode {t_dec:.4f} s "
            f"(cold {t_dcold:.2f} s)", tag)
        del args, enc, dec
    streams_equal = all(np.array_equal(a, b)
                        for a, b in zip(outs[cards][0], outs[1][0]))
    decoded_equal = all(np.array_equal(a, b)
                        for a, b in zip(outs[cards][1], outs[1][1]))
    dpos = outs[cards][1][0].reshape(num_blocks, 3, nb)
    e_pos = max(periodic_err(dpos[b], pos_b[b], BOX)
                for b in range(num_blocks))
    ids_ok = np.array_equal(outs[cards][1][2], ids_b)
    ratio_e = res[1]["encode_s"] / res[cards]["encode_s"]
    ratio_d = res[1]["decode_s"] / res[cards]["decode_s"]
    say("four_cards", f"{cards}-card vs 1-card: encode x{ratio_e:.2f}, "
        f"decode x{ratio_d:.2f}; packed streams "
        f"{'bit-equal' if streams_equal else 'DIFFER'}; decodes "
        f"{'equal' if decoded_equal else 'DIFFER'}; max pos error "
        f"{e_pos:.3e}; IDs {'exact' if ids_ok else 'DIFFER'}", tag)

    mesh = Mesh(np.asarray(jax.devices()[:cards]), ("blocks",))
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        path = os.path.join(tmp, "snap.min")
        with open(path, "wb") as f:
            snapshot.compress_snapshot(f, pos, vel, ids, snapshot_spec(grid),
                                       num_blocks, seed=seed)

        def read():
            with open(path, "rb") as f:
                return snapshot.decompress_snapshot_multihost(f, mesh=mesh)

        got, t_cold = timed(read)
        got, t_read = timed(read)
    gids = np.asarray(got["ids"]).reshape(-1)
    gpos = np.asarray(got["pos"])
    mh_ids_ok = np.array_equal(gids, ids)
    mh_err = max(periodic_err(gpos[b], pos_b[b], BOX)
                 for b in range(num_blocks))
    say("four_cards", f"decompress_snapshot_multihost over {cards} devices: "
        f"{t_read:.3f} s (cold {t_cold:.2f} s); IDs "
        f"{'exact' if mh_ids_ok else 'DIFFER'}, max pos error {mh_err:.3e}",
        tag)
    res.update(streams_equal=streams_equal, pos_err=e_pos, mh_err=mh_err)
    problems = [msg for ok, msg in (
        (streams_equal, "packed streams differ from the 1-device mesh"),
        (decoded_equal, "decodes differ from the 1-device mesh"),
        (e_pos <= POS_DELTA, f"position error {e_pos}"),
        (ids_ok, "IDs differ"), (mh_ids_ok, "multihost-read IDs differ"),
        (mh_err <= POS_DELTA, f"multihost-read position error {mh_err}"))
        if not ok]
    if problems:
        raise AssertionError("; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4 runs only the four-card sharded phase")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    from minnow_c_tpu.bench import harness
    from minnow_c_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform}); "
              "nothing was run", file=sys.stderr)
        return 2
    compile_cache.enable()
    tag = harness.card_tag()
    info = phase_device(tag)
    failed = []

    def run(name, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as exc:  # noqa: BLE001 - report every phase
            failed.append(name)
            say(name, f"FAILED: {type(exc).__name__}: {exc}")
            import traceback
            traceback.print_exc()
            return None

    t0 = time.perf_counter()
    snap = make_snapshot(GRID, args.seed)
    say("data", f"{GRID}^3 displaced lattice from seed {args.seed} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    if args.cards == 4:
        run("four_cards", phase_four_cards, *snap, GRID, args.seed, tag)
    else:
        run("numerics", phase_numerics)
        run("wire", phase_wire, tag=tag)
        run("snapshot", phase_snapshot, *snap, GRID, NUM_BLOCKS, args.seed,
            tag)
        nb = GRID ** 3 // NUM_BLOCKS
        run("delta", phase_delta_family,
            np.ascontiguousarray(snap[0][:, :nb]), args.seed, tag)
    ok = not failed
    result = {"ok": ok, "device": info}
    if failed:
        result["failed"] = failed
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
