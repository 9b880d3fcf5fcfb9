"""Sort v1.1 -- sorted-delta codec with a delta-coded rank stream, frozen.

Wire evolution over Sort v1.0 (a real minor-version bump per the spec's
versioning rules, header_format.tex:266-276): the rank stream is
delta+zigzag chunk-coded instead of packed raw at ``ceil(log2 n)`` bits.
For nearly-sorted inputs (Lagrangian-ordered particle IDs), ranks are
close to the identity permutation, so rank deltas hover near +-1 and pack
in ~2-3 bits instead of ~20 -- while fully random permutations cost about
one extra bit.  Streams stamped 1.0.x keep decoding through the frozen
``algo_sort_v1_0`` module.

Plane payload layout (header as v1.0, rank section re-specified)::

    u32 n_chunks          (sorted-delta chunks, as v1.0)
    u32 first_value
    u32 rank_first        (rank of element 0)
    u32 rank_chunks
    u8  chunk_width[n_chunks]        (padded to 4)
    u8  rank_chunk_width[rank_chunks] (padded to 4)
    <chunked sorted deltas>
    <chunked zigzag rank deltas, element 0 excluded>

This module is FROZEN at v1.1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 1, 0)


import functools

import jax


@functools.partial(jax.jit, static_argnames=("rank_first",))
def _sort11_undo_device(deltas, rz, rank_first: int):
    """Device tail of Sort v1.1 decode: delta cumsum, rank un-zigzag +
    cumsum, un-permute.  Same integer arithmetic as the original host
    numpy path (int64 intermediates, u32 truncation) -- bit-identical."""
    # u32 scans, bit-identical to the original
    # int64/uint64 spellings under disabled x64 (they were already
    # 32-bit) -- signed and unsigned 32-bit addition share bit patterns,
    # so the rank cumsum runs on the unzigzag bits via bitcast.
    sorted_vals = jnp.cumsum(deltas, dtype=jnp.uint32)
    zi = rz.astype(jnp.int32)
    d = (zi >> 1) ^ -(zi & 1)
    rest = jnp.uint32(rank_first) + jnp.cumsum(
        jax.lax.bitcast_convert_type(d, jnp.uint32), dtype=jnp.uint32)
    ranks = jnp.concatenate(
        [jnp.asarray([rank_first], dtype=jnp.uint32), rest])
    ranks = jax.lax.optimization_barrier(ranks)
    sorted_vals = jax.lax.optimization_barrier(sorted_vals)
    return sorted_vals[ranks]


class SortV1_1(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(4, dtype=np.uint32), 0
        order = jnp.argsort(bins, stable=True)
        sorted_vals = bins[order]
        ranks = jnp.zeros(n, dtype=jnp.uint32).at[order].set(
            jnp.arange(n, dtype=jnp.uint32))
        prev = jnp.concatenate([sorted_vals[:1] * 0, sorted_vals[:-1]])
        first = np.uint32(np.asarray(sorted_vals[0]))
        deltas = (sorted_vals - prev).at[0].set(jnp.uint32(0))
        dc, widths = chunked.chunk_widths_auto(deltas)
        body = chunked.pack_chunks_auto(dc, widths)

        rank_first = np.uint32(np.asarray(ranks[0]))
        rz = kernels.u32_delta_zigzag(ranks)[1:]  # element 0 carried raw
        rc, rwidths = chunked.chunk_widths_auto(rz)
        rbody = chunked.pack_chunks_auto(rc, rwidths)

        head = np.array([dc.shape[0], first, rank_first, rc.shape[0]],
                        dtype=np.uint32)
        wtab = np.concatenate(
            [widths, np.zeros((-len(widths)) % 4, dtype=np.uint8)])
        rwtab = np.concatenate(
            [rwidths, np.zeros((-len(rwidths)) % 4, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8), rwtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8),
             np.frombuffer(rbody, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, rank_first, rank_chunks = (int(head[0]),
                                                    np.uint32(head[1]),
                                                    np.uint32(head[2]),
                                                    int(head[3]))
        off = 16
        widths = raw[off:off + n_chunks].astype(np.uint8)
        off += n_chunks + ((-n_chunks) % 4)
        rwidths = raw[off:off + rank_chunks].astype(np.uint8)
        off += rank_chunks + ((-rank_chunks) % 4)
        body = raw[off:].view(np.uint32)

        dw = chunked.total_words(widths)
        deltas = jnp.asarray(
            chunked.unpack_chunks_auto(body[:dw], widths)
        ).reshape(-1)[:n].at[0].set(jnp.uint32(first))
        rz = jnp.asarray(chunked.unpack_chunks_auto(body[dw:], rwidths)
                         ).reshape(-1)[:n - 1]
        # device tail (integer-exact, digests enforce bit-identity)
        return _sort11_undo_device(deltas, rz, int(rank_first))


registry.register(SortV1_1())
