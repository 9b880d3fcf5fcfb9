"""Coil v1.0 -- chunked-width delta codec (patched frame-of-reference),
frozen.

Realizes the spec'd Coil algorithm code (types.h:17, header_format.tex
tab. 3; unimplemented in the reference).  Like Diff, planes store
zigzag-mapped predecessor deltas -- but the pack width is chosen *per
256-element chunk* instead of per plane, so a single large jump (a particle
far from its predecessor) only widens its own chunk.  This is the
classical patched/chunked frame-of-reference layout, arranged for a
vector machine: all chunks of one plane are packed in a single vectorized
pass over a (n_chunks, 256) matrix, using one uniform pass per *distinct*
chunk width (spatially coherent data typically has only a handful).

Plane payload layout::

    u32 n_chunks
    u32 first_value                      (element 0, raw)
    u8  chunk_width[n_chunks]            (zero-padded to 4-byte alignment)
    <per chunk, in order: 256 zigzag deltas packed at chunk_width bits,
     each chunk starting on a u32 word boundary>

The plane prelude ``Width`` field is 0 (widths live in the payload).
Chunks start word-aligned so decode can locate chunk c at word
``sum(ceil(256 * width[j] / 32) for j < c)`` -- a prefix sum of the width
table, no scan of the bitstream.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 0, 0)
CHUNK = chunked.CHUNK  # 256*w bits = 8w words, always word-aligned


class CoilV1_0(TrimV1_0):
    algo_code = int(AlgoCode.COIL)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        bins = jnp.asarray(bins)
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(2, dtype=np.uint32), 0
        first = np.uint32(np.asarray(bins[0]))
        # element 0 is carried raw; keep its slot width-neutral
        z = kernels.u32_delta_zigzag(bins).at[0].set(jnp.uint32(0))
        zc, widths = chunked.chunk_widths_auto(z)
        n_chunks = zc.shape[0]
        body = chunked.pack_chunks_auto(zc, widths)

        head = np.array([n_chunks, first], dtype=np.uint32)
        wtab_pad = (-n_chunks) % 4
        wtab = np.concatenate([widths,
                               np.zeros(wtab_pad, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_chunks = int(raw[:4].view(np.uint32)[0])
        first = np.uint32(raw[4:8].view(np.uint32)[0])
        wtab_pad = (-n_chunks) % 4
        widths = raw[8:8 + n_chunks].astype(np.uint8)
        body = raw[8 + n_chunks + wtab_pad:].view(np.uint32)

        z = chunked.unpack_chunks_auto(body, widths).reshape(-1)[:n]
        # logical-shift unzigzag; the int32 form corrupts |delta| >= 2^30
        d = kernels.u32_unzigzag(jnp.asarray(z))
        d = d.at[0].set(0)
        out = jnp.uint32(first) + jnp.cumsum(d, dtype=jnp.uint32)
        # device-resident: bins stay on device through dequantization
        return out


registry.register(CoilV1_0())
