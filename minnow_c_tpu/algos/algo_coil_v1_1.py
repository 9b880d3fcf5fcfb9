"""Coil v1.1 -- chunked-width delta codec, kernel-friendly layout,
frozen.

Wire evolution over Coil v1.0 (a minor bump per the spec's versioning
rules, header_format.tex:266-276).  Two wire changes let a single-pass
decoder read each chunk as one static tile instead of gathering chunk
bodies at dynamic offsets:

* **Parametric chunk size** (``chunk_log2`` header byte): the encoder
  keeps 256-element chunks below 2^20 values (v1.0-class ratio on small
  planes) and switches to 16384-element chunks at scale, where width
  variation across 256-element windows is noise but per-chunk overhead
  is not.
* **Column-major chunk bodies** (word-of-lane-major,
  ``algos/chunked.body_to_cmajor``): a chunk's funnel-unpack word matrix
  is a contiguous (4*width, chunk/128) tile, so 128 lanes each read
  their own words as static rows.

Plane payload layout::

    u32 n_chunks
    u32 first_value                      (element 0, raw)
    u8  chunk_log2                       (8..17; encoder uses 8 or 14)
    u8  reserved[3]
    u8  chunk_width[n_chunks]            (zero-padded to 4-byte alignment)
    <per chunk, in order: chunk zigzag deltas packed at chunk_width
     bits, column-major, each chunk starting on a u32 word boundary>

Streams stamped 1.0.x keep decoding through the frozen algo_coil_v1_0
module.  This module is FROZEN at v1.1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 1, 0)

KERNEL_CHUNK = 16384     # chunk size for planes of BIG_PLANE or more
SMALL_CHUNK = 256        # v1.0-class chunks for small planes
BIG_PLANE = 1 << 20      # threshold for switching to kernel chunks


def _cmajor_blob(natural: bytes, widths: np.ndarray, chunk: int) -> bytes:
    """Convert a natural-order chunk-body blob (pack_chunks output) to
    the v1.1 column-major layout, chunk by chunk."""
    words = np.frombuffer(natural, dtype=np.uint32)
    wpcs = (chunk * widths.astype(np.int64)) // 32
    offs = np.concatenate([[0], np.cumsum(wpcs)[:-1]])
    out = np.empty_like(words)
    for c in range(len(widths)):
        w = int(widths[c])
        if not w:
            continue
        s = slice(int(offs[c]), int(offs[c] + wpcs[c]))
        out[s] = chunked.body_to_cmajor(words[s], w, chunk)
    return out.astype("<u4", copy=False).tobytes()


def _natural_blob(cmajor: np.ndarray, widths: np.ndarray,
                  chunk: int) -> np.ndarray:
    """Inverse of :func:`_cmajor_blob` (u32 words in, u32 words out)."""
    wpcs = (chunk * widths.astype(np.int64)) // 32
    offs = np.concatenate([[0], np.cumsum(wpcs)[:-1]])
    out = np.empty(int(wpcs.sum()), dtype=np.uint32)
    for c in range(len(widths)):
        w = int(widths[c])
        if not w:
            continue
        s = slice(int(offs[c]), int(offs[c] + wpcs[c]))
        out[s] = chunked.body_from_cmajor(cmajor[s], w, chunk)
    return out


class CoilV1_1(TrimV1_0):
    algo_code = int(AlgoCode.COIL)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(3, dtype=np.uint32), 0
        chunk = KERNEL_CHUNK if n >= BIG_PLANE else SMALL_CHUNK
        first = np.uint32(np.asarray(bins[0]))
        # element 0 is carried raw; keep its slot width-neutral
        z = kernels.u32_delta_zigzag(bins).at[0].set(jnp.uint32(0))
        zc, widths = chunked.chunk_widths_auto(z, chunk)
        n_chunks = zc.shape[0]
        body = _cmajor_blob(chunked.pack_chunks_auto(zc, widths), widths,
                            chunk)

        head = np.array([n_chunks, first], dtype=np.uint32)
        tag = np.array([int(chunk).bit_length() - 1, 0, 0, 0],
                       dtype=np.uint8)
        wtab_pad = (-n_chunks) % 4
        wtab = np.concatenate([widths,
                               np.zeros(wtab_pad, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), tag, wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_chunks = int(raw[:4].view(np.uint32)[0])
        first = int(raw[4:8].view(np.uint32)[0])
        chunk_log2 = int(raw[8])
        if not (8 <= chunk_log2 <= 17):
            raise ValueError(
                f"Coil v1.1 chunk_log2 {chunk_log2} out of range")
        chunk = 1 << chunk_log2
        wtab_pad = (-n_chunks) % 4
        widths = raw[12:12 + n_chunks].astype(np.uint8)
        body = raw[12 + n_chunks + wtab_pad:].view(np.uint32)

        nat = _natural_blob(np.ascontiguousarray(body), widths, chunk)
        z = chunked.unpack_chunks_auto(nat, widths, chunk).reshape(-1)[:n]
        # logical-shift unzigzag; the int32 form corrupts |delta| >= 2^30
        d = kernels.u32_unzigzag(jnp.asarray(z))
        d = d.at[0].set(0)
        return jnp.uint32(first) + jnp.cumsum(d, dtype=jnp.uint32)


registry.register(CoilV1_1())


# ---------------------------------------------------------------------------
# Fused float decode (decompress_segment(fused=True) hook)
# ---------------------------------------------------------------------------
# Mirrors algo_diff_v1_0._fused_for_diff: the plane's bins, then the SAME
# dither+undo tail as the Diff fused plane (bit-identical to decompress +
# dequantize -- same dither spec and keys; the tail is copied op-for-op
# from _diff_plane_fused, which the parity tests pin).

import functools


@functools.partial(jax.jit, static_argnames=("n", "depth", "periodic"))
def _coil11_undo_tail(bins, key, n: int, depth: int, x0, dx, box,
                      periodic: bool):
    from ..ops import rng as _rng
    bins = jax.lax.optimization_barrier(bins)
    bin_w = jnp.float32(dx) / jnp.float32(1 << depth)
    u = _rng.uniform_dither((key[0], key[1]), (n,))
    x = jnp.float32(x0) + bin_w * (bins.astype(jnp.float32) + u)
    if periodic:
        x = jax.lax.optimization_barrier(x)
        x = jnp.where(x >= box, x - box, x)
        x = jnp.where(x < 0, x + box, x)
    return x


def _coil11_plane_floats(self, payload_words, key, n: int, depth: int,
                         x0, dx, box, periodic: bool):
    bins = self._decode_plane(payload_words, 0, n)
    return _coil11_undo_tail(jnp.asarray(bins), key, n, depth, x0, dx,
                             jnp.float32(box), periodic)


def _fused_for_coil11(self, hd, blocks, field_index):
    """decompress_field_fused for Coil v1.1 float fields: the plane's
    bins + the Diff-style undo tail (see TrimV1_0's method for the
    contract)."""
    from ..ops import rng as _rng
    from ..quant.engine import depth_to_delta
    from ..segment.stream import Reader
    from ..types import (Field, FieldCode, FloatAccuracy,
                         PositionAccuracy, VelocityAccuracy)
    from .blocks import decode_block
    from .algo_trim_v1_0 import _payload_words

    code = hd.field_code
    if type(self) is not CoilV1_1:
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
        payload, _, _ = decode_block(blocks[1])
        key = _rng.field_key_arr(seed, field_index, 0)
        x = _coil11_plane_floats(
            self, _payload_words(payload), key, n, depth, x0,
            np.float32(x1) - np.float32(x0), 0.0, False)
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
        payload, _, _ = decode_block(blocks[1 + d])
        key = _rng.field_key_arr(seed, field_index, d)
        # canonical bin width (see TrimV1_0.decompress_field_fused)
        dx_eff = float(np.float32(float(x0a[d]) + max_diff) - x0a[d])
        dims.append(_coil11_plane_floats(
            self, _payload_words(payload), key, n, depth, float(x0a[d]),
            dx_eff, box if is_pos else 0.0, is_pos))
    data = jnp.stack(dims)
    if is_pos:
        acc = PositionAccuracy(
            delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff),
            width=box)
    else:
        acc = VelocityAccuracy(
            delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff))
    return Field(hd=hd, data=data, acc=acc)


CoilV1_1.decompress_field_fused = _fused_for_coil11
