"""L1 compute kernels: vectorized, jittable equivalents of the reference's
``src/util.c`` bit/byte kernel library.

Every function here is pure, shape-static, and safe under ``jax.jit`` /
``shard_map``.  Semantics follow the C reference exactly (cited per
function); the implementations are data-parallel re-designs, not loop
translations -- min/max are reductions, periodic wraps are ``where`` masks,
delta coding is a subtract/cumsum, byte transpose is a shift/mask reshape.

The genuinely hard kernel -- variable-width bitpacking -- lives in
``bitpack.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import rng as _rng


def _exact_pow2_f32(level):
    """2^level as exact f32 for integer depth arrays (level <= 24).

    NOT ``jnp.exp2``: XLA's exp2 is an approximate transcendental even at
    integer inputs (CPU backend: exp2(19.0) == 524287.78), which shifts
    ~0.6% of per-element-depth bin indices off by one vs the C-exact
    semantics (``(float)(1 << level)``, util.c:160-166).  An integer shift
    converted to f32 is exact."""
    return (jnp.uint32(1) << level.astype(jnp.uint32)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Min / max (util.c:27-68)
# ---------------------------------------------------------------------------

def minmax(x):
    """Min and max of a float sequence (util_MinMax, util.c:27-46)."""
    return jnp.min(x), jnp.max(x)


def u64_minmax(x):
    """Min and max of an unsigned integer sequence (util_U64MinMax,
    util.c:48-68)."""
    return jnp.min(x), jnp.max(x)


# ---------------------------------------------------------------------------
# Periodic boundary conditions (util.c:70-143)
# ---------------------------------------------------------------------------

def periodic(x, L):
    """Wrap values into [0, L).  Assumes points are within one box length of
    the range (util_Periodic, util.c:70-84)."""
    L = jnp.float32(L)
    x = jnp.where(x >= L, x - L, x)
    return jnp.where(x < 0, x + L, x)


def u64_periodic(x, L):
    """util_U64Periodic (util.c:86-95)."""
    L = jnp.asarray(L, dtype=x.dtype)
    return jnp.where(x >= L, x - L, x)


def undo_periodic(x, L):
    """Shift a periodically wrapped cluster into one contiguous range: values
    more than L/2 from x[0] are unwrapped across the boundary
    (util_UndoPeriodic, util.c:97-113)."""
    L = jnp.float32(L)
    x0 = x[0]
    x = jnp.where(x - x0 >= L / 2, x - L, x)
    return jnp.where(x - x0 < -L / 2, x + L, x)


def u64_undo_periodic(x, L):
    """util_U64UndoPeriodic (util.c:115-143): signed unwrap around x[0],
    then shift everything up by L if any value went negative.

    Works in int64 like the reference (which views the u64 data as int64).
    """
    xi = x.astype(jnp.int64)
    L_i = jnp.int64(L)
    x0 = xi[0]
    # Reference loop starts at i=1: element 0 is never unwrapped.
    idx = jnp.arange(xi.shape[0]) > 0
    shifted = jnp.where(jnp.logical_and(idx, xi - x0 >= L_i // 2), xi - L_i,
                        xi)
    shifted = jnp.where(jnp.logical_and(idx, xi - x0 < -(L_i // 2)),
                        xi + L_i, shifted)
    needs_lift = jnp.min(shifted) < 0
    return jnp.where(needs_lift, shifted + L_i, shifted).astype(x.dtype)


# ---------------------------------------------------------------------------
# Error-bounded quantization -- the only lossy steps (util.c:145-242)
# ---------------------------------------------------------------------------

def exact_div(x, d):
    """f32 division with IEEE correct rounding on every backend.

    XLA:GPU lowers f32 division to an approximate sequence (a third of
    quotients 1 ulp off on an H200), which flips bin indices at bin
    boundaries against the C-exact wire, and LLVM folds an f64 divide
    that is rounded to f32 back into that same f32 divide.  So the
    backend's quotient q is corrected instead: for a candidate c the
    residual x - c*d is exact in f64 (the product of two f32 needs 48
    bits, and the difference is exact because c*d is within a factor of
    two of x), and the correctly rounded quotient is the candidate with
    the smallest |residual| (a quotient of binary floats is never a tie).
    Two rounds over {q - 1 ulp, q, q + 1 ulp} cover a quotient up to 2
    ulps off; non-finite quotients (d == 0, overflow) are left as the
    backend gives them."""
    x = jnp.asarray(x, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    q0 = x / d
    xw = x.astype(jnp.float64)
    dw = d.astype(jnp.float64)

    def resid(c):
        return jnp.abs(xw - c.astype(jnp.float64) * dw)

    q = q0
    for _ in range(2):
        best, r_best = q, resid(q)
        for c in (jnp.nextafter(q, jnp.float32(np.inf)),
                  jnp.nextafter(q, jnp.float32(-np.inf))):
            r = resid(c)
            take = r < r_best
            best = jnp.where(take, c, best)
            r_best = jnp.where(take, r, r_best)
        q = best
    return jnp.where(jnp.isfinite(q0), q, q0)


def exact_recip(d):
    """rn(1 / d) on every backend (see ``exact_div``)."""
    return exact_div(jnp.float32(1.0), d)


def uniform_bin_index(x, level, x0, dx):
    """Bin indices of x within [x0, x0 + dx) using 2^level bins
    (util_UniformBinIndex, util.c:173-196).

    Out-of-range values (possible only via floating-point error, per the
    reference's contract) clamp to the first / last bin.  Returns uint32;
    level is capped at 24 by the quantization engine (f32 mantissa), so u32
    always suffices.
    """
    x0 = jnp.float32(x0)
    dx = jnp.float32(dx)
    num_bins = jnp.float32(np.float32(1 << int(level))) if isinstance(
        level, (int, np.integer)) else _exact_pow2_f32(level)
    delta = exact_div(x - x0, dx)
    scaled = (delta * num_bins).astype(jnp.uint32)
    top = (num_bins - 1).astype(jnp.uint32)
    out = jnp.where(delta < 0, jnp.uint32(0),
                    jnp.where(delta >= 1, top, scaled))
    # Constant plane (dx == 0): delta = 0/0 = NaN, and NaN->int is
    # hardware-defined (0 on XLA:CPU, unspecified elsewhere).  Pin it to
    # bin 0 so the wire is deterministic everywhere (the reference C is
    # UB here, util.c:159-166; doc/parity_matrix.md divergences).
    return jnp.where(jnp.isnan(delta), jnp.uint32(0), out)


def uniform_bin_index_recip(x, level, x0, dx):
    """The 'recip' scale-mode bin map: multiply by the exactly-rounded
    reciprocal instead of dividing.

        recip  = rn(1 / dx)            (scalar, exact IEEE division)
        q0     = rn(rn(x - x0) * recip)
        bins   = trunc(clamp(q0 * 2^level))

    Every per-element op is an exactly-rounded mul/sub, so this map is
    bit-reproducible on every backend and in numpy, and it replaces a
    per-element division by a multiplication.  |q0 - rn((x-x0)/dx)|
    <= ~1 ulp, so a value within ~1 ulp of a bin boundary may land one
    bin over; the decode-side dither bound grows by at most
    2^-23 * dx -- the same error class the division map itself carries at
    the 24-bit depth cap.  Wire-compatible with every Trim stream (the
    bin map is the encoder's choice; decode never recomputes it).

    Clamp tests run on the pre-scaled plane (exact power-of-two scaling,
    so they are equivalent to tests on q0); NaN (constant plane: dx == 0
    makes recip = inf and q0 = 0 * inf = NaN) pins to bin 0 exactly like
    ``uniform_bin_index``.
    """
    x0 = jnp.float32(x0)
    dx = jnp.float32(dx)
    num_bins = jnp.float32(np.float32(1 << int(level))) if isinstance(
        level, (int, np.integer)) else _exact_pow2_f32(level)
    recip = exact_recip(dx)
    scaled = ((x - x0) * recip) * num_bins
    si = scaled.astype(jnp.int32)
    top = jnp.int32((1 << int(level)) - 1) if isinstance(
        level, (int, np.integer)) else (num_bins - 1).astype(jnp.int32)
    si = jnp.where(scaled < 0, jnp.int32(0),
                   jnp.where(scaled >= num_bins, top, si))
    return jnp.where(jnp.isnan(scaled), jnp.int32(0), si).astype(jnp.uint32)


def recip_bins(x, x0, recip, box, anchor, width: int, periodic: bool):
    """The recip bin map of ``uniform_bin_index_recip`` for one plane whose
    reciprocal range ``recip`` = rn(1 / range) the caller already holds
    (the block-shared range of the batched writers), with the periodic
    unwrap anchored at ``anchor`` (the plane's element 0) folded in.
    Bit-identical per element to unwrapping with ``undo_periodic`` and
    binning with ``uniform_bin_index_recip``."""
    if periodic:
        half = box * jnp.float32(0.5)
        x = jnp.where(x - anchor >= half, x - box, x)
        x = jnp.where(x - anchor < -half, x + box, x)
    nb = jnp.float32(np.float32(np.exp2(width, dtype=np.float64)))
    scaled = ((x - x0) * recip) * nb
    si = scaled.astype(jnp.int32)
    si = jnp.where(scaled < 0, jnp.int32(0),
                   jnp.where(scaled >= nb, jnp.int32((1 << width) - 1), si))
    return jnp.where(jnp.isnan(scaled), jnp.int32(0), si).astype(jnp.uint32)


def bin_index(x, level, x0, dx):
    """Per-element-depth bin indices (util_BinIndex, util.c:145-170).
    ``level`` is a u8/u32 array of per-element bit depths."""
    x0 = jnp.float32(x0)
    dx = jnp.float32(dx)
    num_bins = _exact_pow2_f32(level)
    delta = exact_div(x - x0, dx)
    scaled = (delta * num_bins).astype(jnp.uint32)
    top = (num_bins - 1).astype(jnp.uint32)
    out = jnp.where(delta < 0, jnp.uint32(0),
                    jnp.where(delta >= 1, top, scaled))
    # NaN (constant plane) -> bin 0; see uniform_bin_index.
    return jnp.where(jnp.isnan(delta), jnp.uint32(0), out)


def undo_uniform_bin_index(idx, level, x0, dx, key):
    """Reconstruct floats from bin indices, dithered uniformly within each
    bin (util_UndoUniformBinIndex, util.c:223-242).

    ``key`` is a jax.random key -- the reference threads a sequential
    xoroshiro state here (nondeterministically seeded, quant.c:639); we use
    stateless counter-based dithering so decode is reproducible and
    vectorizes (see ops/rng.py).
    """
    x0 = jnp.float32(x0)
    dx = jnp.float32(dx)
    bins = np.float32(1 << int(level)) if isinstance(
        level, (int, np.integer)) else _exact_pow2_f32(level)
    bin_width = dx / bins
    offset = x0 + bin_width * idx.astype(jnp.float32)
    u = _rng.uniform24(key, idx.shape)
    return offset + u * bin_width


def undo_bin_index(idx, level, x0, dx, key):
    """Per-element-depth inverse (util_UndoBinIndex, util.c:198-221)."""
    x0 = jnp.float32(x0)
    dx = jnp.float32(dx)
    bins = _exact_pow2_f32(level)
    bin_width = dx / bins
    offset = x0 + bin_width * idx.astype(jnp.float32)
    u = _rng.uniform24(key, idx.shape)
    return offset + u * bin_width


# ---------------------------------------------------------------------------
# Byte-plane transpose (util.c:244-281)
# ---------------------------------------------------------------------------

def u32_transpose_bytes(x):
    """Split u32 words into 4 byte planes: output byte i + n*j is byte j of
    word i (util_U32TransposeBytes, util.c:244-259).  Returns uint8 of
    length 4n."""
    planes = [(x >> (8 * j)).astype(jnp.uint8) for j in range(4)]
    return jnp.concatenate(planes)


def u32_undo_transpose_bytes(x):
    """Inverse of u32_transpose_bytes (util_U32UndoTransposeBytes,
    util.c:261-281).  ``x`` is uint8 with length divisible by 4."""
    n = x.shape[0] // 4
    planes = x.reshape(4, n).astype(jnp.uint32)
    out = planes[0]
    for j in range(1, 4):
        out = out | (planes[j] << (8 * j))
    return out


# ---------------------------------------------------------------------------
# Delta coding (util.c:283-309)
# ---------------------------------------------------------------------------

def u8_delta_encode(x):
    """y[0] = x[0]; y[i] = x[i] - x[i-1] with u8 wraparound
    (util_U8DeltaEncode, util.c:283-295)."""
    if x.shape[0] == 0:
        return x
    prev = jnp.concatenate([jnp.zeros((1,), dtype=x.dtype), x[:-1]])
    return x - prev


def u8_undo_delta_encode(x):
    """Prefix-sum inverse of u8_delta_encode (util_U8UndoDeltaEncode,
    util.c:297-309).  cumsum in u8 wraps mod 256 exactly like the C loop."""
    if x.shape[0] == 0:
        return x
    # cumsum on u8 would promote; stay in u32 then truncate (mod-256 exact).
    return jnp.cumsum(x.astype(jnp.uint32)).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Delta + zigzag coding of bin indices (Diff algorithm building block).
# Not present in the reference's util.c -- this realizes the spec'd Diff
# algorithm (types.h:16, header_format.tex tab. 3) as a vectorized
# subtract / cumsum pair.
# ---------------------------------------------------------------------------

def u32_delta_zigzag(bins):
    """Difference each element against its predecessor (element 0 keeps its
    value), then zigzag-map signed deltas to unsigned:
    ``z = (s << 1) ^ (s >> 31)``.  Small |delta| => small z => narrow pack
    width for spatially coherent input orders."""
    s = bins.astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), s[:-1]])
    d = s - prev
    return ((d << 1) ^ (d >> 31)).astype(jnp.uint32)


def u32_unzigzag(z):
    """Inverse zigzag map: z -> signed delta, mod 2^32, as uint32.

    MUST use a LOGICAL right shift: the int32 spelling ``(zi >> 1) ^
    -(zi & 1)`` sign-extends for z >= 2^31, decoding every |delta| >=
    2^30 off by 2^31 (silent corruption for wide UNSI ranges -- the
    encode side is exact mod 2^32)."""
    z = z.astype(jnp.uint32)
    return (z >> jnp.uint32(1)) ^ (jnp.uint32(0) - (z & jnp.uint32(1)))


def u32_undo_delta_zigzag(z):
    """Inverse of u32_delta_zigzag: unzigzag then prefix-sum (wraps mod
    2^32, matching the encode's int32 wrap)."""
    return jnp.cumsum(u32_unzigzag(z)).astype(jnp.uint32)
