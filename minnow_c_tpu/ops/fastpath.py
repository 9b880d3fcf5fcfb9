"""Fused fast paths for the hot codec pipelines.

The performance-critical composition is the reference's "fast uniform"
path (SURVEY.md section 3.3): encode = unwrap -> minmax -> bin ->
pack, decode = unpack -> dithered un-bin -> rewrap.  These helpers fuse
each direction into a single jitted program with
``jax.lax.optimization_barrier`` between stages.

The barriers keep the bitstream unpack (32-way stacked funnel shifts) and
the pack out of the float stages' fusions; they were added against a
compiler that fused those chains into a pathologically slow program.
They cost one round trip of the intermediate through device memory, and
whether the GPU needs them is an open measurement (ROADMAP).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import bitpack, kernels
from . import rng as _rng


@functools.partial(jax.jit,
                   static_argnames=("level", "n", "periodic"))
def _fast_uniform_decode(words, key, level: int, n: int, x0, dx, box,
                         periodic: bool, ctr0):
    bins = bitpack.uniform_unpack(words, level, n)
    bins = jax.lax.optimization_barrier(bins)
    bin_width = jnp.float32(dx) / jnp.float32(1 << level)
    u = _rng.uniform_dither((key[0], key[1]), (n,), ctr0=ctr0)
    x = jnp.float32(x0) + bin_width * (bins.astype(jnp.float32) + u)
    if not periodic:
        return x
    x = jax.lax.optimization_barrier(x)
    return kernels.periodic(x, box)


def fast_uniform_decode(words, key, level: int, n: int, x0, dx,
                        periodic_width=None, ctr0: int = 0):
    """words -> dithered floats: unpack at ``level`` bits, undo bin
    indexing over [x0, x0+dx), optionally rewrap into the periodic box.

    ``key``: (2,) u32 dither key; ``ctr0``: global element offset of this
    plane's first element (for tiled/sharded decode of one logical
    plane).  The box width is a TRACED operand (only its presence is a
    compile key), so snapshots with different box sizes share one
    compiled program per (level, n)."""
    periodic = periodic_width is not None
    box = jnp.float32(periodic_width if periodic else 0.0)
    return _fast_uniform_decode(words, key, level, n, x0, dx, box,
                                periodic, ctr0)


@functools.partial(jax.jit, static_argnames=("level", "periodic"))
def _fast_uniform_encode_xla(x, level: int, box, periodic: bool):
    if periodic:
        x = kernels.undo_periodic(x, box)
    x0 = jnp.min(x)
    x1 = jnp.max(x)
    rng_v = x1 - x0
    bins = kernels.uniform_bin_index(x, level, x0, rng_v)
    bins = jax.lax.optimization_barrier(bins)
    words = bitpack.uniform_pack(bins, level)
    return words, x0, rng_v


@functools.partial(jax.jit, static_argnames=("level", "periodic"))
def _fast_uniform_encode_recip_xla(x, level: int, box, periodic: bool):
    """The recip scale mode: unwrap, min/max, rn(1/range), then the
    anchored recip bin map and the pack."""

    def unwrap(v):
        return kernels.undo_periodic(v, box) if periodic else v

    u1 = unwrap(jax.lax.optimization_barrier(x))
    x0 = jnp.min(u1)
    rng_v = jnp.max(u1) - x0
    recip = kernels.exact_recip(rng_v)
    bins = kernels.recip_bins(x, x0, recip, box, x[0], level, periodic)
    bins = jax.lax.optimization_barrier(bins)
    words = bitpack.uniform_pack(bins, level)
    return words, x0, rng_v


def fast_uniform_encode(x, level: int, periodic_width=None,
                        scale_mode: str = "div"):
    """floats -> (packed words, x0, range): optionally unwrap the periodic
    box, min/max, bin at ``level`` bits, pack.  Returns device arrays;
    the (x0, range) pair is the plane's quantization header.

    ``scale_mode``: 'div' (default) is the C-exact division bin map
    (util.c:173-196 semantics); 'recip' multiplies every element by the
    exactly-rounded reciprocal of the range instead
    (kernels.uniform_bin_index_recip): the same error class, and
    wire-compatible, since the bin map is the encoder's choice and decode
    never recomputes it."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    periodic = periodic_width is not None
    box = jnp.float32(periodic_width if periodic else 0.0)
    if scale_mode == "recip":
        return _fast_uniform_encode_recip_xla(x, level, box, periodic)
    return _fast_uniform_encode_xla(x, level, box, periodic)
