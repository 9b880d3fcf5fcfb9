"""Trim v1.1 -- chunked per-particle-depth packing, frozen.

Wire evolution over Trim v1.0, changing ONLY the Deltas-mode (per-particle
accuracy) plane payload: instead of an exact per-element-width contiguous
bitstream -- whose encoder is a scatter-add (segment-sum) -- each
256-element chunk packs uniformly at the chunk's
maximum depth (``algos/chunked.py`` machinery, vectorized pack/unpack with
bucketed shapes).  Since per-particle accuracy requests cluster in
practice, the size cost is small; the uniform-depth path is byte-identical
to v1.0.

Deltas-mode plane payload::

    u32 n_chunks
    u32 reserved
    u8  chunk_width[n_chunks]   (padded to 4)
    <per chunk: 256 bins packed at chunk_width, word-aligned>

Streams stamped 1.0.x keep decoding through the frozen v1.0 module.

This module is FROZEN at v1.1.
"""

from __future__ import annotations

import numpy as np

from .. import semver
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 1, 0)


class TrimV1_1(TrimV1_0):
    algo_code = int(AlgoCode.TRIM)
    version = VERSION

    def _encode_plane_var(self, bins, depths: np.ndarray):
        # Device path: bins stay on device through pad/reshape/pack
        # (chunked.pack_chunks_auto); only the byte-assembly crosses to
        # the host.  The chunk
        # width table derives from the (tiny-per-chunk) host depths
        # array, NOT the values, so no stats fetch is needed.
        import jax.numpy as jnp
        n = int(bins.shape[0])
        n_chunks = -(-n // chunked.CHUNK) if n else 0
        dp = np.zeros(n_chunks * chunked.CHUNK, dtype=np.uint8)
        dp[:n] = np.asarray(depths, dtype=np.uint8)
        widths = dp.reshape(n_chunks, chunked.CHUNK).max(axis=1) \
            if n_chunks else np.zeros(0, np.uint8)
        if chunked.use_device(bins):
            vals = jnp.asarray(bins).astype(jnp.uint32)
            pad = n_chunks * chunked.CHUNK - n
            if pad:
                vals = jnp.pad(vals, (0, pad))
            vc = vals.reshape(n_chunks, chunked.CHUNK)
        else:
            vals = np.asarray(bins, dtype=np.uint32)
            vp = np.zeros(n_chunks * chunked.CHUNK, dtype=np.uint32)
            vp[:n] = vals
            vc = vp.reshape(n_chunks, chunked.CHUNK)
        body = chunked.pack_chunks_auto(vc, widths)
        head = np.array([n_chunks, 0], dtype=np.uint32)
        wtab = np.concatenate(
            [widths, np.zeros((-n_chunks) % 4, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane_var(self, words: np.ndarray, depths: np.ndarray,
                          n: int):
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_chunks = int(raw[:4].view(np.uint32)[0])
        widths = raw[8:8 + n_chunks].astype(np.uint8)
        body = raw[8 + n_chunks + ((-n_chunks) % 4):].view(np.uint32)
        # device-resident on an accelerator (chunked.unpack_chunks_auto);
        # bins feed the fused undo without a host round trip
        return chunked.unpack_chunks_auto(body, widths).reshape(-1)[:n]


registry.register(TrimV1_1())
