"""Variable-width bitpacking: store the low ``width`` bits of each u32
contiguously in a little-endian bitstream.

Semantics match ``util_U32UniformPack`` / ``util_U32UndoUniformPack``
(util.c:311-406): bit b of element i lands at global bit ``i*width + b``;
global bit g lives in output word ``g // 32`` at position ``g % 32``; spare
bits in the last word are zero.  Word-straddling elements split across two
words exactly as in the C straddle branch (util.c:343-351).

Data-parallel design -- no sequential bit cursor, no scatter:

* ``uniform_pack``: 32 elements at ``width`` bits fill exactly ``width``
  words, so each element's lo/hi word contributions sit at static
  (word, shift) positions and fold into the block's words (disjoint bits
  => OR == ADD).  Everything is elementwise ops and one fold per block;
  there is no data-dependent control flow.

* ``uniform_unpack``: the decode hot path -- the same static block
  structure read back with 32 column slices and funnel shifts, no gather.
  A gather-based funnel read (``uniform_unpack_gather``) and a dense
  bit-matrix unpack (``uniform_unpack_dense``) with identical semantics
  are kept for cross-checking.

* ``pack`` / ``unpack``: per-element widths (the Deltas/per-particle-depth
  mode).  Bit offsets are an exclusive prefix sum of widths; contributions
  are folded with a segment-sum over destination words.

All functions are jit-safe with static ``width``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def packed_words(n: int, width: int) -> int:
    """Number of u32 words needed to pack n elements at ``width`` bits
    (util.c:316-317)."""
    return pl_cdiv(n * width, 32)


# Block structure: 32 elements at `width` bits occupy exactly `width` u32
# words (32*width bits).  Within a block every element's bit window is at a
# *static* (word, offset), so pack and unpack reduce to static
# column-slice/shift/or steps over a (n_blocks, width) word matrix -- pure
# vectorized work with no gathers, no scatters, and no 32x bit-matrix
# blowup.  The wire bitstream is unchanged from the C semantics.


def _pack_fold_32(vals, width: int):
    """The einsum-select fold: (n_blocks, 32) masked u32 values ->
    (n_blocks, width) packed words.  Element k's lo/hi word contributions
    are whole-matrix shifts by static per-column amounts, folded into the
    ``width`` output words with static 0/1 selection matrices (disjoint
    bits => integer matmul == OR).  Chosen over a 32-way slice/OR unroll,
    which XLA's CPU backend miscompiles (wrong bits for interior columns,
    observed jax 0.9.0), and over scatter-adds; on the GPU a masked sum
    over the 32-element axis measured slower than this product
    (PERF.md)."""
    lsh = np.array([(k * width) % 32 for k in range(32)], dtype=np.uint32)
    tgt = np.array([(k * width) // 32 for k in range(32)])
    straddle = (lsh + width) > 32
    lo = vals << jnp.asarray(lsh)[None, :]
    rsh = np.where(straddle, 32 - lsh, 0).astype(np.uint32)
    hi = jnp.where(jnp.asarray(straddle)[None, :],
                   vals >> jnp.asarray(rsh)[None, :], jnp.uint32(0))
    sel_lo = np.zeros((32, width), dtype=np.uint32)
    sel_lo[np.arange(32), tgt] = 1
    sel_hi = np.zeros((32, width), dtype=np.uint32)
    in_range = tgt + 1 < width
    sel_hi[np.arange(32)[in_range], (tgt + 1)[in_range]] = 1
    return lo @ jnp.asarray(sel_lo) + hi @ jnp.asarray(sel_hi)


@functools.partial(jax.jit, static_argnames=("width",))
def uniform_pack(x, width: int):
    """Pack the low ``width`` bits of each element of u32 array ``x``
    (util_U32UniformPack, util.c:311-355)."""
    n = x.shape[0]
    n_words = packed_words(n, width)
    if width == 0 or n == 0:
        return jnp.zeros((n_words,), dtype=jnp.uint32)
    if width == 32:
        return x
    n_blocks = pl_cdiv(n, 32)
    pad = n_blocks * 32 - n
    if pad:
        x = jnp.pad(x, (0, pad))
    vals = x.reshape(n_blocks, 32) & jnp.uint32((1 << width) - 1)
    words = _pack_fold_32(vals, width)
    return words.reshape(-1)[:n_words]


@functools.partial(jax.jit, static_argnames=("width",))
def uniform_pack_rows(x, width: int):
    """Pack each row of u32 array ``x`` of shape (rows, n) independently;
    requires ``n % 32 == 0``.  Row r's stream is bit-identical to
    ``uniform_pack(x[r], width)`` and occupies exactly (n//32)*width words
    (no partial tail word when 32 divides n), so the result is the dense
    (rows, (n//32)*width) matrix of per-row streams.

    Folds the batch into the fold's row dimension, so every stream of
    the batch packs in one 2-D fold instead of a vmapped (batched) one."""
    rows, n = x.shape
    if n % 32 != 0:
        raise ValueError("uniform_pack_rows requires n % 32 == 0")
    out_words = (n // 32) * width
    if width == 0 or n == 0:
        return jnp.zeros((rows, out_words), dtype=jnp.uint32)
    if width == 32:
        return x
    vals = x.reshape(rows * (n // 32), 32) & jnp.uint32((1 << width) - 1)
    words = _pack_fold_32(vals, width)
    return words.reshape(rows, out_words)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def uniform_unpack_blocked(x, width: int, n: int):
    """Block-structured unpack: static column slices + funnel shifts, no
    gather.  Semantics identical to ``uniform_unpack``."""
    if n == 0:
        return jnp.zeros((0,), dtype=jnp.uint32)
    if width == 0:
        return jnp.zeros((n,), dtype=jnp.uint32)
    if width == 32:
        return x[:n]
    n_blocks = pl_cdiv(n, 32)
    pad_words = n_blocks * width - x.shape[0]
    if pad_words > 0:
        x = jnp.pad(x, (0, pad_words))
    words = x.reshape(n_blocks, width)
    mask = jnp.uint32((1 << width) - 1)
    outs = []
    for k in range(32):  # element k of each block
        start = k * width
        j = start // 32
        off = start % 32
        v = words[:, j] >> jnp.uint32(off)
        if off + width > 32:
            v = v | (words[:, j + 1] << jnp.uint32(32 - off))
        outs.append(v & mask)
    return jnp.stack(outs, axis=1).reshape(-1)[:n]


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def uniform_unpack(x, width: int, n: int):
    """Unpack ``n`` elements of ``width`` bits from u32 array ``x``
    (util_U32UndoUniformPack, util.c:357-406) with the block-structured
    no-gather unpack."""
    return uniform_unpack_blocked(x, width, n)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def uniform_unpack_gather(x, width: int, n: int):
    """Gather-based funnel unpack: pair adjacent words into u64 windows,
    one 64-bit read + shift per element.  Kept for cross-checking; the
    blocked unpack is the default."""
    if n == 0:
        return jnp.zeros((0,), dtype=jnp.uint32)
    if width == 0:
        return jnp.zeros((n,), dtype=jnp.uint32)
    if width == 32:
        return x[:n]
    hi = jnp.concatenate([x[1:], jnp.zeros((1,), dtype=jnp.uint32)])
    w64 = x.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))
    # 64-bit global bit offsets: u32 wraps past 2^32 bits (~134M
    # elements at width 32), silently gathering from the stream start.
    start = jnp.arange(n, dtype=jnp.uint64) * jnp.uint64(width)
    word = (start >> jnp.uint64(5)).astype(jnp.int64)
    off = (start & jnp.uint64(31)).astype(jnp.uint64)
    window = w64[word]  # gather
    mask = jnp.uint64((1 << width) - 1)
    return ((window >> off) & mask).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def uniform_unpack_dense(x, width: int, n: int):
    """Bit-matrix unpack with identical semantics to ``uniform_unpack`` --
    used as a cross-check and as a u64-free path."""
    if n == 0:
        return jnp.zeros((0,), dtype=jnp.uint32)
    if width == 0:
        return jnp.zeros((n,), dtype=jnp.uint32)
    if width == 32:
        return x[:n]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :]
    bits = ((x[:, None] >> shifts) & jnp.uint32(1)).reshape(-1)
    bits = bits[: n * width].reshape(n, width)
    weights = (jnp.uint32(1) << jnp.arange(width, dtype=jnp.uint32))[None, :]
    return jnp.sum(bits * weights, axis=1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Per-element widths (variable-depth mode)
# ---------------------------------------------------------------------------


def var_packed_words(widths) -> int:
    """Host-side: words needed for per-element widths (numpy array)."""
    total = int(np.sum(widths.astype(np.int64)))
    return total // 32 + (0 if total % 32 == 0 else 1)


@functools.partial(jax.jit, static_argnames=("n_words",))
def pack(x, widths, n_words: int):
    """Pack element i's low ``widths[i]`` bits contiguously.  ``n_words``
    must equal ``var_packed_words(widths)`` (static for jit).

    Per-element bit offsets are an exclusive scan of widths; each element
    contributes to at most two words (width <= 32), folded with two
    segment-sums (disjoint bits => ADD == OR).
    """
    n = x.shape[0]
    if n == 0 or n_words == 0:
        return jnp.zeros((n_words,), dtype=jnp.uint32)
    w = widths.astype(jnp.uint32)
    mask = jnp.where(w >= 32, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << w) - jnp.uint32(1))
    val = (x & mask).astype(jnp.uint64)
    start = jnp.cumsum(w.astype(jnp.uint64)) - w.astype(jnp.uint64)
    word = (start >> jnp.uint64(5)).astype(jnp.int32)
    off = start & jnp.uint64(31)
    shifted = val << off  # fits in 63 bits (width<=32, off<=31)
    lo = (shifted & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (shifted >> jnp.uint64(32)).astype(jnp.uint32)
    out = jax.ops.segment_sum(lo, word, num_segments=n_words + 1)
    out = out + jax.ops.segment_sum(hi, word + 1, num_segments=n_words + 1)
    return out[:n_words].astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=())
def unpack(x, widths):
    """Inverse of ``pack``: extract element i's ``widths[i]`` bits.  Output
    length equals ``widths`` length."""
    n = widths.shape[0]
    if n == 0:
        return jnp.zeros((0,), dtype=jnp.uint32)
    w = widths.astype(jnp.uint64)
    start = jnp.cumsum(w) - w
    word = (start >> jnp.uint64(5)).astype(jnp.int32)
    off = start & jnp.uint64(31)
    hi = jnp.concatenate([x[1:], jnp.zeros((1,), dtype=jnp.uint32)])
    w64 = x.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))
    window = w64[word]
    mask = jnp.where(w >= 64, jnp.uint64(0xFFFFFFFFFFFFFFFF),
                     (jnp.uint64(1) << w) - jnp.uint64(1))
    return ((window >> off) & mask).astype(jnp.uint32)
