"""Sort v1.2 -- sorted-delta codec with parametric chunks and an
order-free profile, frozen.

Wire evolution over Sort v1.1 (minor bump, header_format.tex:266-276):

* **Parametric chunk size + column-major chunk bodies** (the Coil v1.1
  layout, algos/chunked.py) for both the sorted-delta stream and the
  rank stream.
* **Order-free profile** (``mode`` payload byte): the client can drop
  the rank stream entirely.  Decode then returns values in ASCENDING
  order -- lossless VALUES, surrendered ORDER -- which is Sort's actual
  niche: for order-free analysis archives (histograms, spectra, spatial
  statistics over scalar fields) the rank stream is pure overhead, and
  sorted deltas pack far below every other codec (a permutation-dense
  ID field collapses to ~1 bit/element; see doc/ratio_table.md's sort_of
  row and tests/test_ratio_sweep.py).  Restricted to single-plane
  fields (UNSF/UNSI): 3-dim fields sort planes independently, so
  dropping ranks would break x/y/z tuple pairing.
* Both streams store element 0 raw with a zero placeholder (the Coil
  layout) instead of v1.1's excluded-element rank stream.

Profile selection rides the PATCH byte of the requested version
(encoder-side choice, like ``scale_mode``): 1.2.0 keeps ranks, 1.2.1
writes order-free.  The stream itself is self-describing (the ``mode``
byte); one frozen module decodes both, honoring the patch-insensitive
decode contract (header_format.tex:280-282).

Plane payload layout::

    u32 n_chunks
    u32 first_value            (element 0 of the SORTED stream, raw)
    u32 rank_first             (rank of element 0; 0 in order-free mode)
    u32 rank_chunks            (0 in order-free mode)
    u8  chunk_log2
    u8  mode                   (0 = ranked, 1 = order-free)
    u8  reserved[2]
    u8  chunk_width[n_chunks]            (padded to 4)
    u8  rank_chunk_width[rank_chunks]    (padded to 4)
    <chunked sorted deltas, column-major>
    <chunked zigzag rank deltas (mode 0 only), column-major>

This module is FROZEN at v1.2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_coil_v1_1 import BIG_PLANE, KERNEL_CHUNK, SMALL_CHUNK, \
    _cmajor_blob, _natural_blob
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 2, 0)
ORDER_FREE_PATCH = 1   # request version 1.2.1 to drop the rank stream


def _encode_chunked(z: np.ndarray, chunk: int):
    """Pack a u32 stream (element 0 already zeroed) into the v1.2
    chunked layout: (widths, cmajor body bytes)."""
    zc, widths = chunked.chunk_widths_auto(jnp.asarray(z), chunk)
    body = _cmajor_blob(chunked.pack_chunks_auto(zc, widths), widths,
                        chunk)
    return widths, body


def _decode_chunked(body: np.ndarray, widths: np.ndarray, first: int,
                    chunk: int, n: int, zigzag: bool):
    """Decode one chunked stream to ``first + cumsum(un-zigzag?(...))``,
    device-resident on an accelerator."""
    nat = _natural_blob(np.ascontiguousarray(body), widths, chunk)
    z = chunked.unpack_chunks_auto(nat, widths, chunk).reshape(-1)[:n]
    z = jnp.asarray(z)
    d = kernels.u32_unzigzag(z) if zigzag else z
    d = d.at[0].set(0)
    return jnp.uint32(first) + jnp.cumsum(d, dtype=jnp.uint32)


class SortV1_2(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION

    def compress(self, qf):
        # mode rides the requested patch byte (encoder-side choice; the
        # stream stays self-describing via the payload mode flag)
        order_free = semver.patch(qf.hd.algo_version) == ORDER_FREE_PATCH
        if order_free:
            from ..types import FieldCode
            if qf.data.ndim > 1:  # .ndim is metadata: np.asarray
                # would D2H the whole device-resident bins array
                raise ValueError(
                    "Sort v1.2 order-free profile (patch 1) is for "
                    "single-plane fields only: 3-dim fields sort planes "
                    "independently, so dropping ranks would break tuple "
                    "pairing")
            if (qf.hd.field_code == FieldCode.UNSI and
                    int(qf.quant.x1) - int(qf.quant.x0) > 0xFFFFFFFF):
                # wide-range u64 splits into lo+hi PLANES (Trim
                # _compress_uint); only the lo plane would sort, pairing
                # mismatched halves on decode -- silent corruption
                raise ValueError(
                    "Sort v1.2 order-free profile cannot encode UNSI "
                    "fields whose value range exceeds 2^32: the u64 "
                    "stream splits into lo+hi planes, which is no "
                    "longer single-plane (use the ranked profile)")
        if not order_free:
            return super().compress(qf)
        # per-call shallow copy: the registry holds ONE shared instance,
        # and stashing mutable mode state on it would make compress
        # non-reentrant (a leaked flag emits rank-free streams for data
        # that needed ranks)
        import copy
        enc = copy.copy(self)
        enc._order_free = True
        return TrimV1_0.compress(enc, qf)

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(5, dtype=np.uint32), 0
        chunk = KERNEL_CHUNK if n >= BIG_PLANE else SMALL_CHUNK
        order_free = bool(getattr(self, "_order_free", False))

        order = jnp.argsort(bins, stable=True)
        sorted_vals = bins[order]
        first = np.uint32(np.asarray(sorted_vals[0]))
        prev = jnp.concatenate([sorted_vals[:1] * 0, sorted_vals[:-1]])
        deltas = (sorted_vals - prev).at[0].set(jnp.uint32(0))
        dwidths, dbody = _encode_chunked(np.asarray(deltas), chunk)

        if order_free:
            rank_first = np.uint32(0)
            rwidths = np.zeros(0, np.uint8)
            rbody = b""
        else:
            ranks = jnp.zeros(n, dtype=jnp.uint32).at[order].set(
                jnp.arange(n, dtype=jnp.uint32))
            rank_first = np.uint32(np.asarray(ranks[0]))
            rz = kernels.u32_delta_zigzag(ranks).at[0].set(jnp.uint32(0))
            rwidths, rbody = _encode_chunked(np.asarray(rz), chunk)

        head = np.array([len(dwidths), first, rank_first, len(rwidths)],
                        dtype=np.uint32)
        tag = np.array([int(chunk).bit_length() - 1,
                        1 if order_free else 0, 0, 0], dtype=np.uint8)
        wtab = np.concatenate(
            [dwidths, np.zeros((-len(dwidths)) % 4, dtype=np.uint8)])
        rwtab = np.concatenate(
            [rwidths, np.zeros((-len(rwidths)) % 4, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), tag, wtab.view(np.uint8),
             rwtab.view(np.uint8),
             np.frombuffer(dbody, dtype=np.uint8),
             np.frombuffer(rbody, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, rank_first, rank_chunks = (
            int(head[0]), int(head[1]), int(head[2]), int(head[3]))
        chunk_log2 = int(raw[16])
        mode = int(raw[17])
        if not (8 <= chunk_log2 <= 17):
            raise ValueError(
                f"Sort v1.2 chunk_log2 {chunk_log2} out of range")
        chunk = 1 << chunk_log2
        off = 20
        dwidths = raw[off:off + n_chunks].astype(np.uint8)
        off += n_chunks + ((-n_chunks) % 4)
        rwidths = raw[off:off + rank_chunks].astype(np.uint8)
        off += rank_chunks + ((-rank_chunks) % 4)
        body = raw[off:].view(np.uint32)

        dw = chunked.total_words(dwidths, chunk)
        sorted_vals = _decode_chunked(body[:dw], dwidths, first, chunk,
                                      n, zigzag=False)
        if mode == 1:
            # order-free profile: ascending values, no rank stream
            return sorted_vals
        ranks = _decode_chunked(body[dw:], rwidths, rank_first, chunk,
                                n, zigzag=True)
        ranks = jax.lax.optimization_barrier(ranks)
        sorted_vals = jax.lax.optimization_barrier(sorted_vals)
        # the order-restoring element gather is the ranked decode's
        # costliest step -- the order-free profile exists to skip it
        return sorted_vals[ranks]


registry.register(SortV1_2())
