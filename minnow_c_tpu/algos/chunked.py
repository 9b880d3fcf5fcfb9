"""Chunked-width bitstream helpers shared by the Coil and Sort codecs.

Chunks of ``CHUNK`` elements pack at per-chunk widths, each chunk starting
on a u32 word boundary (CHUNK is a multiple of 32, so a chunk at width w
is exactly ``CHUNK*w/32`` words).

Shape discipline: every device call here uses *bucketed* shapes -- the
number of same-width chunks passed to one pack/unpack call is rounded up
to a power of two (padding with zero chunks) -- so the set of compiled
programs is O(widths x log chunks) and the persistent jit cache converges
quickly.  Without this, data-dependent group sizes force a fresh XLA
compilation per segment.

Wire behavior is identical to per-group exact-shape packing (padding is
dropped before bytes are emitted); the frozen-digest tests pin this.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..ops import bitpack

CHUNK = 256


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def chunk_widths(z: np.ndarray, chunk: int = CHUNK
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a u32 stream into (n_chunks, chunk) rows (zero-padded) and
    per-chunk bit widths."""
    n = z.shape[0]
    n_chunks = -(-n // chunk)
    zp = np.zeros(n_chunks * chunk, dtype=np.uint32)
    zp[:n] = z
    zc = zp.reshape(n_chunks, chunk)
    maxes = zc.max(axis=1)
    # bit_length(m) == ceil(log2(m + 1)); exact in f64 for all u32
    # (vectorized -- the Python-loop version costs ~390k interpreter
    # iterations per 100M-element plane)
    widths = np.ceil(np.log2(maxes.astype(np.float64) + 1.0)).astype(
        np.uint8)
    return zc, widths


def pack_chunks(zc: np.ndarray, widths: np.ndarray) -> bytes:
    """Pack each chunk row at its width; returns the concatenated
    word-aligned chunk bodies as bytes (in chunk order)."""
    from ..utils.debug import debug_assert
    n_chunks = zc.shape[0]
    debug_assert(widths.shape[0] == n_chunks, "widths/chunks mismatch")
    # O(n) scan: every chunk's values must fit its declared width, or the
    # pack silently drops bits (DebugAssert tier -- free in release).
    debug_assert(
        lambda: n_chunks == 0 or bool((
            ((zc.max(axis=1) >> np.minimum(widths, 31).astype(np.uint32))
             == 0) | (widths.astype(np.int64) >= 32)).all()),
        "chunk value exceeds declared width")
    chunk = int(zc.shape[1]) if n_chunks else CHUNK
    chunk_bytes = [b""] * n_chunks
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        m = len(idx)
        mp = _next_pow2(m)
        rows = np.zeros((mp, chunk), dtype=np.uint32)
        rows[:m] = zc[idx]
        # native C++ pack: byte-identical to bitpack.uniform_pack (the
        # oracle relationship is tested) with no XLA compilation --
        # width-diverse streams (Octo's Morton plane) would otherwise
        # compile ~20 (width, size) programs
        from ..ops import native as _native
        packed = _native.uniform_pack_host(rows.reshape(-1), int(wv))
        wpc = chunk * int(wv) // 32
        packed = packed[: mp * wpc].reshape(mp, wpc)
        le = packed.astype("<u4", copy=False)
        for row, c in enumerate(idx):
            chunk_bytes[c] = le[row].tobytes()
    # NOTE: the per-chunk tobytes loop is O(n_chunks) Python; at 100M
    # elements that is ~390k iterations per plane.  Kept for now -- the
    # snapshot writer's hot path uses the uniform row-folded pack, not
    # this chunked path (Coil/Sort only).
    return b"".join(chunk_bytes)


def unpack_chunks(body: np.ndarray, widths: np.ndarray,
                  chunk: int = CHUNK) -> np.ndarray:
    """Inverse of pack_chunks: ``body`` is the concatenated u32 words,
    ``widths`` the per-chunk widths.  Returns (n_chunks, chunk) u32."""
    n_chunks = widths.shape[0]
    if n_chunks and int(widths.max()) > 32:
        # wire-sourced width table: malformed (checksum-colliding or
        # buggy-writer) streams must fail cleanly, not IndexError deep
        # inside the gather below
        raise ValueError(
            f"chunk width {int(widths.max())} > 32 in stream width table")
    words_per_chunk = (chunk * widths.astype(np.int64)) // 32
    offsets = np.concatenate([[0], np.cumsum(words_per_chunk)])
    out = np.zeros((n_chunks, chunk), dtype=np.uint32)
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        m = len(idx)
        wpc = chunk * int(wv) // 32
        # vectorized gather of all same-width chunk bodies
        gidx = offsets[idx][:, None] + np.arange(wpc)[None, :]
        rows = body[gidx]  # (m, wpc)
        mp = _next_pow2(m)
        if mp != m:
            rows = np.concatenate(
                [rows, np.zeros((mp - m, wpc), dtype=np.uint32)])
        from ..ops import native as _native
        vals = _native.uniform_unpack_host(
            np.ascontiguousarray(rows.reshape(-1)), int(wv), mp * chunk)
        out[idx] = vals.reshape(mp, chunk)[:m]
    return out


def total_words(widths: np.ndarray, chunk: int = CHUNK) -> int:
    return int(((chunk * widths.astype(np.int64)) // 32).sum())


def body_to_cmajor(natural: np.ndarray, width: int, chunk: int
                   ) -> np.ndarray:
    """Rearrange one chunk's packed words from natural bitstream order
    (word k = bits [32k, 32k+32)) to the v1.1 column-major wire layout
    (flat[c*M + m] = natural[4*width*m + c], M = chunk // 128)."""
    if width == 0:
        return natural
    M = chunk // 128
    return np.ascontiguousarray(
        np.asarray(natural).reshape(M, 4 * width).T).reshape(-1)


def body_from_cmajor(cmajor: np.ndarray, width: int, chunk: int
                     ) -> np.ndarray:
    """Inverse of :func:`body_to_cmajor`."""
    if width == 0:
        return cmajor
    M = chunk // 128
    return np.ascontiguousarray(
        np.asarray(cmajor).reshape(4 * width, M).T).reshape(-1)


# ---------------------------------------------------------------------------
# Device-resident bucketed machinery
# ---------------------------------------------------------------------------
# The numpy paths above loop per distinct width with host gathers and an
# O(n_chunks) per-chunk tobytes join -- host-bound at snapshot scale.
# The device versions below keep the stream on device end to end:
#   * one barriered device gather per distinct width (typically <= 8 on
#     coherent data) groups same-width chunk bodies contiguously;
#   * each bucket unpacks/packs as ONE flat uniform stream (chunks are
#     word-aligned, so the concatenation of same-width chunk bodies IS a
#     valid uniform stream);
#   * chunk order is restored with a single row-granular inverse-
#     permutation take.
# Wire bytes are identical to the numpy path (frozen digests enforce);
# tests/test_algos.py asserts value-parity of both paths directly.


def use_device(x) -> bool:
    """The one host-or-device choice of the chunked codecs: the device
    path when ``x`` lives on an accelerator.  A jax array answers with
    its own devices; a host (numpy) array with the device JAX would place
    it on (``jax.default_device`` when set, else the first device)."""
    import jax
    devices = getattr(x, "devices", None)
    if callable(devices):
        dev = next(iter(devices()))
    else:
        dev = jax.config.jax_default_device or jax.devices()[0]
    return (dev if isinstance(dev, str) else dev.platform) != "cpu"


def _bit_widths_device(maxes):
    """ceil(log2(m + 1)) per element, exact for all u32 (compare against
    the 33 powers of two; no float round-trip)."""
    import jax.numpy as jnp
    # bit_length(m) = #{k in 0..31 : m > 2^k - 1}; thresholds 0,1,3,...,
    # 2^31-1 all fit u32.
    pows = np.uint64(1) << np.arange(0, 32, dtype=np.uint64)
    thresh = jnp.asarray((pows - 1).astype(np.uint32))
    return jnp.sum(maxes[:, None] > thresh[None, :], axis=1).astype(
        jnp.uint8)


def chunk_widths_device(z, chunk: int = CHUNK):
    """Device analog of ``chunk_widths``: z (n,) u32 device array ->
    (zc (n_chunks, chunk) device, widths (n_chunks,) host u8).  One small
    D2H fetch (the width table -- it goes in the wire payload anyway)."""
    import jax.numpy as jnp
    n = int(z.shape[0])
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        z = jnp.pad(z, (0, pad))
    zc = z.reshape(n_chunks, chunk)
    widths = np.asarray(_bit_widths_device(jnp.max(zc, axis=1)))
    return zc, widths


def chunk_widths_auto(z, chunk: int = CHUNK):
    """``chunk_widths`` on the side :func:`use_device` picks for ``z``
    (the device path returns a device ``zc``; one small width-table
    fetch)."""
    if use_device(z):
        import jax.numpy as jnp
        return chunk_widths_device(jnp.asarray(z), chunk)
    return chunk_widths(np.asarray(z), chunk)


_MAX_DEVICE_WIDTHS = 8  # beyond this many DISTINCT chunk widths, one
# device program per width costs more compilation than the device saves;
# the native host path is byte-identical and compile-free (the limit
# waits for a measurement of compile times on the GPU)


def pack_chunks_auto(zc, widths: np.ndarray) -> bytes:
    """``pack_chunks`` on the side :func:`use_device` picks for ``zc``;
    identical bytes either way.  Width-diverse streams always pack on the
    host (see _MAX_DEVICE_WIDTHS)."""
    if use_device(zc) and \
            len(np.unique(widths)) <= _MAX_DEVICE_WIDTHS:
        import jax.numpy as jnp
        return pack_chunks_device(jnp.asarray(zc), widths)
    return pack_chunks(np.asarray(zc), widths)


def unpack_chunks_auto(body, widths: np.ndarray, chunk: int = CHUNK):
    """``unpack_chunks`` on the side :func:`use_device` picks for
    ``body``; the device path returns a DEVICE (n_chunks, chunk) array
    (value-identical), the host path numpy.  Width-diverse streams always
    unpack on the host (see _MAX_DEVICE_WIDTHS)."""
    if use_device(body) and \
            len(np.unique(widths)) <= _MAX_DEVICE_WIDTHS:
        return unpack_chunks_device(body, widths, chunk)
    return unpack_chunks(np.asarray(body), widths, chunk)


def unpack_chunks_device(body, widths: np.ndarray, chunk: int = CHUNK):
    """Device-resident ``unpack_chunks``: ``body`` u32 words (device or
    host), ``widths`` host u8 table.  Returns a DEVICE (n_chunks, chunk)
    u32 array, value-identical to ``unpack_chunks``."""
    import jax
    import jax.numpy as jnp
    n_chunks = widths.shape[0]
    if n_chunks == 0:
        return jnp.zeros((0, chunk), jnp.uint32)
    if int(widths.max()) > 32:
        raise ValueError(
            f"chunk width {int(widths.max())} > 32 in stream width table")
    words_per_chunk = (chunk * widths.astype(np.int64)) // 32
    offsets = np.concatenate([[0], np.cumsum(words_per_chunk)])
    # Device gather indices below are int32; a plane beyond 2^31 packed
    # words (~8 GiB) would silently wrap where the host path's int64
    # offsets stay exact.  Fail loudly instead (advisor round-4 finding).
    if int(offsets[-1]) >= 2**31:
        raise ValueError(
            f"plane has {int(offsets[-1])} packed words >= 2^31; the "
            "device chunked path's int32 gather indices would overflow "
            "-- split the plane into smaller blocks")
    body_d = jnp.asarray(body)
    outs = []
    order = []
    for wv in np.unique(widths):
        idx = np.nonzero(widths == wv)[0]
        order.append(idx)
        m = len(idx)
        if wv == 0:
            outs.append(jnp.zeros((m, chunk), jnp.uint32))
            continue
        wpc = chunk * int(wv) // 32
        mp = _next_pow2(m)
        off = np.zeros(mp, dtype=np.int32)
        off[:m] = offsets[idx]
        # (mp, wpc) gather indices built on device from the (mp,) offsets
        gi = (jnp.asarray(off)[:, None] +
              jnp.arange(wpc, dtype=jnp.int32)[None, :]).reshape(-1)
        rows = jnp.take(body_d, gi, mode="clip")
        # Barrier: keeps the gather out of the unpack's fusion (see
        # ops/fastpath.py).
        rows = jax.lax.optimization_barrier(rows)
        vals = bitpack.uniform_unpack(rows, int(wv), mp * chunk)
        outs.append(vals.reshape(mp, chunk)[:m])
    cat = jnp.concatenate(outs) if len(outs) > 1 else outs[0]
    src = np.concatenate(order)
    if np.array_equal(src, np.arange(n_chunks)):
        return cat
    inv = np.empty(n_chunks, dtype=np.int32)
    inv[src] = np.arange(n_chunks, dtype=np.int32)
    return jax.lax.optimization_barrier(
        jnp.take(cat, jnp.asarray(inv), axis=0))


def pack_chunks_device(zc, widths: np.ndarray) -> bytes:
    """Device-resident ``pack_chunks``: zc (n_chunks, CHUNK) u32 device
    array, widths host u8.  Byte-identical output."""
    import jax
    import jax.numpy as jnp
    n_chunks = int(zc.shape[0])
    if n_chunks == 0:
        return b""
    chunk = int(zc.shape[1])
    words_per_chunk = (chunk * widths.astype(np.int64)) // 32
    offsets = np.concatenate([[0], np.cumsum(words_per_chunk)])
    nw = int(offsets[-1])
    if nw == 0:
        return b""
    if nw >= 2**31:
        raise ValueError(
            f"plane has {nw} packed words >= 2^31; the device chunked "
            "path's int32 scatter indices would overflow -- split the "
            "plane into smaller blocks")
    # bucket-major packed words + their destination word offsets
    parts = []
    dest = []
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        m = len(idx)
        wpc = chunk * int(wv) // 32
        mp = _next_pow2(m)
        rows = zc[jnp.asarray(idx)]
        rows = jax.lax.optimization_barrier(rows)  # gather barrier
        if mp != m:
            rows = jnp.concatenate(
                [rows, jnp.zeros((mp - m, chunk), jnp.uint32)])
        packed = bitpack.uniform_pack(rows.reshape(-1), int(wv))
        parts.append(packed[: m * wpc])
        dest.append((offsets[idx][:, None] +
                     np.arange(wpc)[None, :]).reshape(-1))
    cat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    dst = np.concatenate(dest)
    if np.array_equal(dst, np.arange(nw)):
        body = cat
    else:
        inv = np.empty(nw, dtype=np.int32)
        inv[dst] = np.arange(nw, dtype=np.int32)
        body = jax.lax.optimization_barrier(
            jnp.take(cat, jnp.asarray(inv)))
    return np.asarray(body).astype("<u4", copy=False).tobytes()
