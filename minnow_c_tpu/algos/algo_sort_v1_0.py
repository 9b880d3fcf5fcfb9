"""Sort v1.0 -- sorted-delta + permutation codec, frozen.

Realizes the spec'd Sort algorithm code (header_format.tex tab. 3;
unimplemented in the reference).  Each plane's bins are sorted; the sorted
sequence is stored as non-negative first-differences (whose *sum* is the
value range, so their average width is ``log2(range/n)`` -- far below the
raw depth for clustered distributions), and the original order is restored
by a rank stream packed at ``ceil(log2 n)`` bits.

Cost model: ``log2(range/n) + log2(n) = log2(range)`` -- break-even with
Trim on uniform data, a win whenever values cluster (the sorted deltas
then concentrate near zero and chunk-pack narrowly).  For nearly-sorted
inputs (Lagrangian-ordered IDs), the rank stream itself is coherent and
LZ4 collapses it.

Plane payload layout::

    u32 n_chunks         (sorted-delta chunks of 256, Coil-style widths)
    u32 first_value      (smallest value)
    u32 rank_words       (words in the rank stream)
    u32 reserved
    u8  chunk_width[n_chunks]  (padded to 4-byte alignment)
    <chunked sorted deltas, each chunk word-aligned>
    <ranks packed at ceil(log2 n) bits>

Sorting runs on device (XLA sort); rank extraction is the argsort inverse.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import bitpack
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 0, 0)
CHUNK = chunked.CHUNK


def _bits_for(v: int) -> int:
    return max(1, int(v).bit_length())


import functools

import jax


@functools.partial(jax.jit, static_argnames=("rank_width", "n"))
def _sort_undo_device(deltas, rank_body, rank_width: int, n: int):
    """Device tail of Sort v1.0 decode: cumsum the sorted deltas, unpack
    the rank stream, un-permute.  Integer-exact, so bit-identical to the
    original host numpy path (frozen decode digests enforce).  Barriers
    keep the gather from fusing into consumers (~100x pathology)."""
    # u32 scan, bit-identical to the original: with x64 disabled its
    # uint64 cast was already uint32, and u32 addition wraps
    # associatively.
    sorted_vals = jnp.cumsum(deltas, dtype=jnp.uint32)
    ranks = bitpack.uniform_unpack(rank_body, rank_width, n)
    ranks = jax.lax.optimization_barrier(ranks)
    sorted_vals = jax.lax.optimization_barrier(sorted_vals)
    return sorted_vals[ranks]


class SortV1_0(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(4, dtype=np.uint32), 0
        order = jnp.argsort(bins, stable=True)
        sorted_vals = bins[order]
        # ranks[i] = position of element i in the sorted sequence
        ranks = jnp.zeros(n, dtype=jnp.uint32).at[order].set(
            jnp.arange(n, dtype=jnp.uint32))
        prev = jnp.concatenate([sorted_vals[:1] * 0, sorted_vals[:-1]])
        first = np.uint32(np.asarray(sorted_vals[0]))
        deltas = (sorted_vals - prev).at[0].set(jnp.uint32(0))

        dc, widths = chunked.chunk_widths_auto(deltas)
        n_chunks = dc.shape[0]
        body = chunked.pack_chunks_auto(dc, widths)

        rank_width = _bits_for(n - 1)
        rank_words = np.asarray(bitpack.uniform_pack(ranks, rank_width))

        head = np.array([n_chunks, first, rank_words.size, 0],
                        dtype=np.uint32)
        wtab_pad = (-n_chunks) % 4
        wtab = np.concatenate([widths, np.zeros(wtab_pad, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8),
             rank_words.view(np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, n_rank_words = int(head[0]), np.uint32(head[1]), \
            int(head[2])
        wtab_pad = (-n_chunks) % 4
        widths = raw[16:16 + n_chunks].astype(np.uint8)
        body = raw[16 + n_chunks + wtab_pad:].view(np.uint32)

        total_delta_words = chunked.total_words(widths)
        deltas = jnp.asarray(
            chunked.unpack_chunks_auto(body[:total_delta_words], widths)
        ).reshape(-1)[:n].at[0].set(jnp.uint32(first))

        rank_width = _bits_for(n - 1)
        rank_body = body[total_delta_words:total_delta_words + n_rank_words]
        # cumsum + rank unpack + un-permute run on device; bins stay
        # device-resident through dequantization.
        return _sort_undo_device(deltas,
                                 jnp.asarray(rank_body), rank_width, n)


registry.register(SortV1_0())
