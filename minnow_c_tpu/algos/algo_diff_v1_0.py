"""Diff v1.0 -- predecessor-delta codec, frozen.

Realizes the spec'd Diff algorithm code (types.h:16, header_format.tex
tab. 3; the reference never implements it): identical block/metadata
layout to Trim v1.0, but each data plane stores zigzag-mapped differences
against the previous element, packed at the width of the largest zigzag
value.  For spatially coherent input orders (cell-sorted snapshots,
Lagrangian ID order) successive bin indices are close, so the delta stream
packs far below the raw ``depth`` bits; worst case costs one extra bit
(zigzag sign).

The client controls data order (spec table 1: "Optimally ordering data" is
the client's duty; "Maintaining data order" is ours), so Diff never
reorders -- it simply exploits whatever coherence the order has.

Decode is a prefix sum (``ops/kernels.u32_undo_delta_zigzag``): the running
sum telescopes to the original bins, so intermediates stay in range.

Wire notes vs Trim v1.0: the block prelude ``Width`` field stores the
zigzag width (not the quantization depth -- that lives in the metadata
block), and per-particle-depth (Deltas) fields fall back to Trim's raw
variable-width packing unchanged.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import bitpack, kernels
from ..types import AlgoCode
from . import registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 0, 0)


class DiffV1_0(TrimV1_0):
    algo_code = int(AlgoCode.DIFF)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = bins.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32), 1
        # Element 0 is stored raw in the plane's first word: its "delta" is
        # the absolute value, whose zigzag would otherwise force
        # width = depth + 1 for the whole plane.
        z = kernels.u32_delta_zigzag(bins)[1:]
        first = np.uint32(np.asarray(bins[0]))
        # One tiny host sync per plane: the zigzag width is data-dependent
        # and must be static for the pack.
        zmax = int(np.asarray(jnp.max(z))) if z.shape[0] else 0
        width = max(1, int(zmax).bit_length())
        words = np.asarray(bitpack.uniform_pack(z, width))
        return np.concatenate([[first], words]).astype(np.uint32), width

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        first = jnp.uint32(words[0])
        z = bitpack.uniform_unpack(jnp.asarray(words[1:]), width, n - 1)
        # Logical-shift unzigzag (kernels.u32_unzigzag): the old int32
        # spelling corrupted every |delta| >= 2^30.  All-u32 arithmetic
        # wraps mod 2^32 exactly like the encode.
        d = kernels.u32_unzigzag(z)
        rest = first + jnp.cumsum(d, dtype=jnp.uint32)
        # device-resident: bins stay on device through dequantization
        return jnp.concatenate([jnp.asarray([first], dtype=jnp.uint32),
                                rest])


import functools

import jax


@functools.partial(jax.jit, static_argnames=("width", "n", "depth",
                                             "periodic"))
def _diff_plane_fused(words, key, width: int, n: int, depth: int, x0, dx,
                      box, periodic: bool):
    """Fused device decode of one Diff plane: unpack zigzag deltas ->
    cumsum -> bins -> dithered undo -> optional periodic rewrap.  Bit-
    identical to _decode_plane + engine undo (same ops, same dither)."""
    from ..ops import rng as _rng

    first = jnp.uint32(words[0])
    z = bitpack.uniform_unpack(words[1:], width, n - 1)
    z = jax.lax.optimization_barrier(z)
    d = kernels.u32_unzigzag(z)  # logical shift; int32 corrupts >= 2^30
    rest = first + jnp.cumsum(d, dtype=jnp.uint32)
    bins = jnp.concatenate([jnp.asarray([first], dtype=jnp.uint32),
                            rest])
    bins = jax.lax.optimization_barrier(bins)
    bin_w = jnp.float32(dx) / jnp.float32(1 << depth)
    u = _rng.uniform_dither((key[0], key[1]), (n,))
    x = jnp.float32(x0) + bin_w * (bins.astype(jnp.float32) + u)
    if periodic:
        x = jax.lax.optimization_barrier(x)
        x = jnp.where(x >= box, x - box, x)
        x = jnp.where(x < 0, x + box, x)
    return x


def _fused_for_diff(self, hd, blocks, field_index):
    """decompress_field_fused for Diff-coded fields (see TrimV1_0's for
    the contract)."""
    from ..ops import rng as _rng
    from ..quant.engine import depth_to_delta
    from ..segment.stream import Reader
    from ..types import (Field, FieldCode, FloatAccuracy, PositionAccuracy,
                         VelocityAccuracy)
    from .blocks import decode_block

    code = hd.field_code
    if type(self) is not DiffV1_0:
        return None
    if code not in (FieldCode.POSN, FieldCode.VELC, FieldCode.UNSF):
        return None
    if not blocks or any(b is None for b in blocks):
        return None
    n = hd.particle_len
    if n < 2:
        return None
    if len(blocks) < (2 if code == FieldCode.UNSF else 4):
        return None  # short-but-checksum-valid list: let generic degrade
    meta, _, _ = decode_block(blocks[0])
    r = Reader(meta.tobytes())
    if code == FieldCode.UNSF:
        x0 = r.f32()
        x1 = r.f32()
        depth = r.u8()
        if r.u8() or r.u8():
            return None  # per-particle depths / log scaling
        r.u8()
        r.f32()
        seed = r.u64()
        payload, w, _ = decode_block(blocks[1])
        words = jnp.asarray(np.frombuffer(payload.tobytes(), dtype="<u4"))
        key = _rng.field_key_arr(seed, field_index, 0)
        x = _diff_plane_fused(words, key, w, n, depth, x0,
                              np.float32(x1) - np.float32(x0),
                              jnp.float32(0.0), False)
        return Field(hd=hd, data=x,
                     acc=FloatAccuracy(delta=depth_to_delta(depth, x0, x1)))

    is_pos = code == FieldCode.POSN
    x0 = tuple(r.f32() for _ in range(3))
    x1 = tuple(r.f32() for _ in range(3))
    if is_pos:
        box = r.f32()
    depth = r.u8()
    if r.u8():
        return None
    if not is_pos:
        if r.u8():
            return None
        r.u8()
        r.f32()
    else:
        r.u16()
    seed = r.u64()
    x0a = np.asarray(x0, dtype=np.float32)
    x1a = np.asarray(x1, dtype=np.float32)
    max_diff = float(np.float32(np.max(x1a - x0a)))
    dims = []
    for d in range(3):
        payload, w, _ = decode_block(blocks[1 + d])
        words = jnp.asarray(np.frombuffer(payload.tobytes(), dtype="<u4"))
        key = _rng.field_key_arr(seed, field_index, d)
        # canonical bin width (see TrimV1_0.decompress_field_fused)
        dx_eff = float(np.float32(float(x0a[d]) + max_diff) - x0a[d])
        dims.append(_diff_plane_fused(
            words, key, w, n, depth, float(x0a[d]), dx_eff,
            jnp.float32(box if is_pos else 0.0), is_pos))
    data = jnp.stack(dims)
    if is_pos:
        acc = PositionAccuracy(
            delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff),
            width=box)
    else:
        acc = VelocityAccuracy(
            delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff))
    return Field(hd=hd, data=data, acc=acc)


DiffV1_0.decompress_field_fused = _fused_for_diff

registry.register(DiffV1_0())
