"""Quantization engine: per-field-type quantize / dequantize.

Accelerator-first re-design of the reference's ``src/quant.c``.  The engine is split
into *pure jitted array passes* and a thin host orchestration layer:

* ``*_prepare`` passes (unwrap / remap / min-max) and ``*_bins`` passes
  (bin indexing) run on device under jit with static shapes.
* Bit depths are data-dependent (they follow from the observed value range,
  quant.c:675-733), so the orchestrator syncs the tiny stats (6 floats per
  field) to the host, derives depths with C-exact f32 arithmetic, and feeds
  them back as *static* parameters -- keeping downstream bitpack shapes
  static for XLA.

Reference call structure: position() quant.c:161-224, velocity()
quant.c:226-289, id() quant.c:291-327, ufloat() quant.c:329-371, uint()
quant.c:373-398, inverses quant.c:405-608.

Documented divergences from the reference (SURVEY.md "known defects"):
  * decode dithering is seeded from a header-carried seed (deterministic)
    instead of ``clock()`` (quant.c:639);
  * undoPosition dequantizes dim i with range ``maxDiff`` (matching how the
    encoder binned it) and with dim i's own bins -- the reference passes
    ``quant.X1[i]`` and the dim-0 bin pointer for every dim
    (quant.c:476-479), which cannot round-trip;
  * position/velocity bin buffers are sized 3*n (the reference
    under-allocates, quant.c:173,238);
  * symlog10 mapping is implemented (the reference Panics,
    quant.c:623-632): y = sign(x) * log10(1 + |x|/t), inverted exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kernels
from ..ops import rng as _rng
from ..types import (
    Field,
    FieldCode,
    FloatAccuracy,
    FloatQuantization,
    IDAccuracy,
    IDQuantization,
    IntAccuracy,
    IntQuantization,
    PositionAccuracy,
    PositionQuantization,
    QField,
    VelocityAccuracy,
    VelocityQuantization,
)

MAX_DEPTH = 24  # f32 mantissa limit (quant.c:684-693)

from ..utils.debug import debug_assert as _dbg  # noqa: E402  (DebugAssert
# tier, debug.h:52-63: O(n) invariant scans gated behind MINNOW_DEBUG)


# ---------------------------------------------------------------------------
# depth <-> delta (quant.c:654-733), C-exact f32 arithmetic
# ---------------------------------------------------------------------------

def delta_to_depth(delta: float, x0: float, x1: float) -> int:
    """Minimal bit depth whose bin width beats ``delta`` over [x0, x1]:
    first depth with ``delta * 2^depth > x1 - x0`` in f32
    (deltaToDepth, quant.c:681-696)."""
    delta = np.float32(delta)
    rng = np.float32(x1) - np.float32(x0)
    for depth in range(MAX_DEPTH + 1):
        if delta * np.float32(1 << depth) > rng:
            return depth
    raise ValueError(
        f"accuracy {delta} over range [{x0}, {x1}] exceeds f32 granularity "
        f"(> {MAX_DEPTH} bits of mantissa)")


def deltas_to_depths(deltas: np.ndarray, x0: float, x1: float) -> np.ndarray:
    """Vectorized per-element depths (deltaToDepth array branch,
    quant.c:698-732).  The condition is monotone in depth, so the depth is
    the count of failing levels."""
    deltas = np.asarray(deltas, dtype=np.float32)
    rng = np.float32(x1) - np.float32(x0)
    # C-exact (float)(1 << depth) scales (quant.c:713); float powf is
    # not guaranteed correctly rounded for 2^k on every platform.
    scales = (np.int64(1) << np.arange(MAX_DEPTH + 1)).astype(
        np.float32)
    ok = deltas[:, None] * scales[None, :] > rng  # (n, 25)
    depths = np.argmax(ok, axis=1).astype(np.uint8)
    if not np.all(ok[np.arange(len(deltas)), depths]):
        raise ValueError(
            f"per-element accuracy exceeds f32 granularity over "
            f"[{x0}, {x1}]")
    return depths


def depth_to_delta(depth: int, x0: float, x1: float) -> float:
    """Achieved accuracy reported back to the user (depthToDelta,
    quant.c:654-673)."""
    return float((np.float32(x1) - np.float32(x0)) /
                 np.float32(1 << int(depth)))


def depths_to_deltas(depths: np.ndarray, x0: float, x1: float) -> np.ndarray:
    d = np.asarray(depths).astype(np.int64)
    return ((np.float32(x1) - np.float32(x0)) /
            (np.int64(1) << d).astype(np.float32)).astype(np.float32)


# ---------------------------------------------------------------------------
# float mappings (mapFloat / unmap, quant.c:735-757 + our symlog10)
# ---------------------------------------------------------------------------

def map_float(x, log10_scaled: int, threshold: float):
    if log10_scaled == 0:
        return x
    if log10_scaled == 1:
        return jnp.log10(x)
    if log10_scaled == 2:
        t = jnp.float32(threshold)
        return jnp.sign(x) * jnp.log10(1.0 + jnp.abs(x) / t)
    raise ValueError(f"log10_scaled must be 0, 1, or 2; got {log10_scaled}")


def unmap_float(y, log10_scaled: int, threshold: float):
    """Inverse float mapping (quant.c:735-757 analog).

    Precision note (bounded by tests/test_quant.py TestUnmapPrecision):
    the log10/symlog inverses compute ``exp2(y * log2 10)`` in f32; the
    f32 rounding of the product plus XLA's exp2 give a *mapped-space*
    round-trip error |log10(unmap(y)) - y| <= |y| * 8e-8 + 1.2e-6 over
    the entire f32-representable range -- equivalently a relative value
    error <= ~8e-6.  This is far inside any delta at depths <= 20; at
    depth 24 over a narrow mapped range it can reach a few bins, which
    is inherent to f32 transcendental decode (the dither tolerance and
    frozen digests pin the exact bits)."""
    if log10_scaled == 0:
        return y
    if log10_scaled == 1:
        return jnp.exp2(y * jnp.float32(np.log2(10.0)))
    if log10_scaled == 2:
        t = jnp.float32(threshold)
        mag = jnp.exp2(jnp.abs(y) * jnp.float32(np.log2(10.0)))
        return jnp.sign(y) * t * (mag - 1.0)
    raise ValueError(f"log10_scaled must be 0, 1, or 2; got {log10_scaled}")


# ---------------------------------------------------------------------------
# jitted array passes
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("width",))
def pos_prepare(x, width: float):
    """Unwrap each dimension across the periodic boundary and compute
    per-dim ranges (quant.c:180-192).  x: (3, n) f32."""
    xu = jax.vmap(lambda d: kernels.undo_periodic(d, width))(x)
    x0 = jnp.min(xu, axis=1)
    x1 = jnp.max(xu, axis=1)
    return xu, x0, x1


@functools.partial(jax.jit, static_argnames=("log10_scaled", "threshold"))
def vel_prepare(x, log10_scaled: int, threshold: float):
    """Optionally symlog-map and compute per-dim ranges (quant.c:245-256)."""
    xm = map_float(x, log10_scaled, threshold)
    x0 = jnp.min(xm, axis=1)
    x1 = jnp.max(xm, axis=1)
    return xm, x0, x1


@functools.partial(jax.jit, static_argnames=("log10_scaled", "threshold"))
def ufloat_prepare(x, log10_scaled: int, threshold: float):
    xm = map_float(x, log10_scaled, threshold)
    return xm, jnp.min(xm), jnp.max(xm)


@functools.partial(jax.jit, static_argnames=("depth",))
def dims_bins_uniform(xu, x0, dx, depth: int):
    """Bin each of the 3 dims with a shared range ``dx`` and per-dim origin
    (quant.c:198-209)."""
    return jax.vmap(
        lambda xd, o: kernels.uniform_bin_index(xd, depth, o, dx))(xu, x0)


@functools.partial(jax.jit, static_argnames=("depth",))
def dims_bins_uniform_recip(xu, x0, dx, depth: int):
    """Recip-scale-mode variant of ``dims_bins_uniform``
    (kernels.uniform_bin_index_recip): same error class, different
    (encoder-side) bin map."""
    return jax.vmap(
        lambda xd, o: kernels.uniform_bin_index_recip(xd, depth, o, dx))(
            xu, x0)


@jax.jit
def dims_bins_var(xu, x0, dx, depths):
    return jax.vmap(
        lambda xd, o: kernels.bin_index(xd, depths, o, dx))(xu, x0)


@functools.partial(jax.jit, static_argnames=("width",))
def id_decompose(ids, width: int):
    """Split Lagrangian IDs into 3D grid coordinates, unwrap each dim, and
    subtract the minimum -- fully lossless (id(), quant.c:291-327)."""
    w = jnp.uint64(width)
    qx = ids % w
    qy = (ids // w) % w
    qz = ids // (w * w)
    dims = jnp.stack([qx, qy, qz])
    dims = jax.vmap(lambda d: kernels.u64_undo_periodic(d, width))(dims)
    x0 = jnp.min(dims, axis=1)
    x1 = jnp.max(dims, axis=1)
    return dims - x0[:, None], x0, x1


@functools.partial(jax.jit, static_argnames=("width",))
def id_recompose(qdims, x0, width: int):
    """Inverse of id_decompose (undoID, quant.c:553-587): re-add the per-dim
    minimum, re-wrap into [0, width), and recombine."""
    w = jnp.uint64(width)
    dims = qdims + x0[:, None]
    dims = jnp.where(dims >= w, dims - w, dims)
    return dims[0] + w * dims[1] + w * w * dims[2]


@functools.partial(jax.jit, static_argnames=("depth",))
def undo_float_uniform(bins, x0, x1, depth: int, key):
    """x0 + dx*(q + U[0,1)) with dx = (x1-x0)/2^depth (undoFloat,
    quant.c:634-652), counter-based dither."""
    dx = (jnp.float32(x1) - jnp.float32(x0)) / jnp.float32(1 << depth)
    u = _rng.uniform24(key, bins.shape)
    return jnp.float32(x0) + dx * (bins.astype(jnp.float32) + u)


@jax.jit
def undo_float_var(bins, x0, x1, depths, key):
    from ..ops.kernels import _exact_pow2_f32
    dx = ((jnp.float32(x1) - jnp.float32(x0)) /
          _exact_pow2_f32(depths))  # exact 2^depth (XLA exp2 is not)
    u = _rng.uniform24(key, bins.shape)
    return jnp.float32(x0) + dx * (bins.astype(jnp.float32) + u)


# ---------------------------------------------------------------------------
# Orchestration: quantize / dequantize one field (quant_QField / quant_Field,
# quant.c:135-155)
# ---------------------------------------------------------------------------

def quantize(field: Field, seed: int = 0,
             scale_mode: str = "div") -> QField:
    """Quantize one field.  ``scale_mode``: 'div' (default) is the
    C-exact division bin map; 'recip' multiplies by the exactly-rounded
    reciprocal (kernels.uniform_bin_index_recip) -- an encoder-side map;
    wire-compatible, same error class."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    from ..utils import native_order
    data = native_order(field.data)
    if data is not field.data:  # never mutate the caller's Field
        field = Field(hd=field.hd, data=data, acc=field.acc)
    code = field.hd.field_code
    if code == FieldCode.POSN:
        return _quantize_position(field, seed, scale_mode)
    if code == FieldCode.VELC:
        return _quantize_velocity(field, seed, scale_mode)
    if code == FieldCode.PTID:
        return _quantize_id(field)
    if code == FieldCode.UNSF:
        return _quantize_ufloat(field, seed, scale_mode)
    if code == FieldCode.UNSI:
        return _quantize_uint(field)
    raise ValueError(f"unrecognized field code {code:#x}")


def dequantize(qf: QField, field_index: int = 0) -> Field:
    code = qf.hd.field_code
    if code == FieldCode.POSN:
        return _dequantize_position(qf, field_index)
    if code == FieldCode.VELC:
        return _dequantize_velocity(qf, field_index)
    if code == FieldCode.PTID:
        return _dequantize_id(qf)
    if code == FieldCode.UNSF:
        return _dequantize_ufloat(qf, field_index)
    if code == FieldCode.UNSI:
        return _dequantize_uint(qf)
    raise ValueError(f"unrecognized field code {code:#x}")


def _dims_quantize(xm, x0, x1, delta, deltas, scale_mode: str = "div"):
    """Shared 3-dim float quantize core (position/velocity both follow
    quant.c:161-289: per-dim x0, shared max_diff range, one depth or
    per-element depths).  Returns (bins, depth, depths, x0_h, x1_h).

    ``scale_mode`` 'recip' swaps the uniform bin map for
    kernels.uniform_bin_index_recip (Deltas mode always uses the div
    map; the per-element path is host/scatter-bound, not
    division-bound)."""
    x0_h = np.asarray(x0)
    x1_h = np.asarray(x1)
    max_diff = float(np.float32(np.max(x1_h - x0_h)))
    if deltas is None:
        depth = delta_to_depth(delta, x0_h[0], x0_h[0] + max_diff)
        fn = dims_bins_uniform_recip if scale_mode == "recip" \
            else dims_bins_uniform
        bins = fn(xm, x0, jnp.float32(max_diff), depth)
        return bins, depth, None, x0_h, x1_h
    depths = deltas_to_depths(deltas, x0_h[0], x0_h[0] + max_diff)
    bins = dims_bins_var(xm, x0, jnp.float32(max_diff),
                         jnp.asarray(depths))
    return bins, 0, depths, x0_h, x1_h


def _dims_dequantize(q, data, field_index, post):
    """Shared 3-dim dequantize loop: per-dim dithered undo + ``post``
    (periodic rewrap for positions, unmap for velocities).  Returns
    (stacked dims, max_diff, x0 array)."""
    x0 = np.asarray(q.x0, dtype=np.float32)
    x1 = np.asarray(q.x1, dtype=np.float32)
    max_diff = float(np.float32(np.max(x1 - x0)))
    bins = jnp.asarray(data).reshape(3, -1)
    dims = []
    for i in range(3):
        key = _rng.field_key_arr(q.seed, field_index, i)
        if q.depths is None:
            xd = undo_float_uniform(bins[i], float(x0[i]),
                                    float(x0[i]) + max_diff, q.depth, key)
        else:
            xd = undo_float_var(bins[i], float(x0[i]),
                                float(x0[i]) + max_diff,
                                jnp.asarray(q.depths), key)
        dims.append(post(xd))
    return jnp.stack(dims), max_diff, x0


def _quantize_position(field: Field, seed: int,
                       scale_mode: str = "div") -> QField:
    acc: PositionAccuracy = field.acc
    x = jnp.asarray(field.data, dtype=jnp.float32).reshape(3, -1)
    xu, x0, x1 = pos_prepare(x, float(acc.width))
    bins, depth, depths, x0_h, x1_h = _dims_quantize(
        xu, x0, x1, acc.delta, acc.deltas, scale_mode)
    if depths is None:
        _dbg(lambda: int(jnp.max(bins)) < (1 << depth),
             "position bin index exceeds 2^depth")

    quant = PositionQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        width=float(acc.width), depth=depth, depths=depths, seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_position(qf: QField, field_index: int) -> Field:
    q: PositionQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index, lambda xd: kernels.periodic(xd, q.width))

    if q.depths is None:
        acc = PositionAccuracy(
            delta=depth_to_delta(q.depth, x0[0], x0[0] + max_diff),
            width=q.width)
    else:
        acc = PositionAccuracy(
            delta=0.0, width=q.width,
            deltas=depths_to_deltas(q.depths, x0[0], x0[0] + max_diff))
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_velocity(field: Field, seed: int,
                       scale_mode: str = "div") -> QField:
    acc: VelocityAccuracy = field.acc
    # The reference treats ANY nonzero SymLog10Scaled as symlog10
    # (quant.c:248); velocities are signed, so plain log10 (flag 1)
    # would NaN on them.
    sym = 2 if acc.sym_log10_scaled else 0
    x = jnp.asarray(field.data, dtype=jnp.float32).reshape(3, -1)
    xm, x0, x1 = vel_prepare(x, sym, float(acc.sym_log10_threshold))
    bins, depth, depths, x0_h, x1_h = _dims_quantize(
        xm, x0, x1, acc.delta, acc.deltas, scale_mode)

    quant = VelocityQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        depth=depth, depths=depths,
        sym_log10_scaled=sym,
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_velocity(qf: QField, field_index: int) -> Field:
    q: VelocityQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index,
        lambda yd: unmap_float(yd, q.sym_log10_scaled,
                               q.sym_log10_threshold))

    if q.depths is None:
        acc = VelocityAccuracy(
            delta=depth_to_delta(q.depth, x0[0], x0[0] + max_diff),
            sym_log10_scaled=q.sym_log10_scaled,
            sym_log10_threshold=q.sym_log10_threshold)
    else:
        acc = VelocityAccuracy(
            delta=0.0, deltas=depths_to_deltas(q.depths, x0[0],
                                               x0[0] + max_diff),
            sym_log10_scaled=q.sym_log10_scaled,
            sym_log10_threshold=q.sym_log10_threshold)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_id(field: Field) -> QField:
    acc: IDAccuracy = field.acc
    ids = jnp.asarray(field.data, dtype=jnp.uint64).reshape(-1)
    qdims, x0, x1 = id_decompose(ids, int(acc.width))
    x0_h = np.asarray(x0)
    x1_h = np.asarray(x1)
    quant = IDQuantization(width=int(acc.width),
                           x0=tuple(int(v) for v in x0_h),
                           x1=tuple(int(v) for v in x1_h))
    # Coordinates after min-subtraction fit far below 2^32 (width^3 <= 2^64
    # => width < 2^22), so store u32 bins.
    return QField(hd=field.hd, data=qdims.astype(jnp.uint32), quant=quant)


def _dequantize_id(qf: QField) -> Field:
    q: IDQuantization = qf.quant
    qdims = jnp.asarray(qf.data).astype(jnp.uint64).reshape(3, -1)
    ids = id_recompose(qdims, jnp.asarray(np.array(q.x0, dtype=np.uint64)),
                       q.width)
    return Field(hd=qf.hd, data=ids, acc=IDAccuracy(width=q.width))


def _quantize_ufloat(field: Field, seed: int,
                     scale_mode: str = "div") -> QField:
    acc: FloatAccuracy = field.acc
    x = jnp.asarray(field.data, dtype=jnp.float32).reshape(-1)
    xm, x0, x1 = ufloat_prepare(x, int(acc.log10_scaled),
                                float(acc.sym_log10_threshold))
    x0_h = float(np.asarray(x0))
    x1_h = float(np.asarray(x1))

    if acc.deltas is None:
        depth = delta_to_depth(acc.delta, x0_h, x1_h)
        bin_fn = kernels.uniform_bin_index_recip if scale_mode == "recip" \
            else kernels.uniform_bin_index
        bins = bin_fn(
            xm, depth, x0_h, np.float32(x1_h) - np.float32(x0_h))
        depths = None
    else:
        depths = deltas_to_depths(acc.deltas, x0_h, x1_h)
        bins = kernels.bin_index(
            xm, jnp.asarray(depths), x0_h,
            np.float32(x1_h) - np.float32(x0_h))
        depth = 0

    quant = FloatQuantization(
        x0=x0_h, x1=x1_h, depth=depth, depths=depths,
        log10_scaled=int(acc.log10_scaled),
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_ufloat(qf: QField, field_index: int) -> Field:
    q: FloatQuantization = qf.quant
    bins = jnp.asarray(qf.data).reshape(-1)
    key = _rng.field_key_arr(q.seed, field_index, 0)
    if q.depths is None:
        y = undo_float_uniform(bins, q.x0, q.x1, q.depth, key)
    else:
        y = undo_float_var(bins, q.x0, q.x1, jnp.asarray(q.depths), key)
    data = unmap_float(y, q.log10_scaled, q.sym_log10_threshold)

    if q.depths is None:
        acc = FloatAccuracy(delta=depth_to_delta(q.depth, q.x0, q.x1),
                            log10_scaled=q.log10_scaled,
                            sym_log10_threshold=q.sym_log10_threshold)
    else:
        acc = FloatAccuracy(delta=0.0,
                            deltas=depths_to_deltas(q.depths, q.x0, q.x1),
                            log10_scaled=q.log10_scaled,
                            sym_log10_threshold=q.sym_log10_threshold)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_uint(field: Field) -> QField:
    ids = jnp.asarray(field.data, dtype=jnp.uint64).reshape(-1)
    x0 = jnp.min(ids)
    x1 = jnp.max(ids)
    x0_h = int(np.asarray(x0))
    x1_h = int(np.asarray(x1))
    rel = ids - x0
    quant = IntQuantization(x0=x0_h, x1=x1_h)
    if x1_h - x0_h <= 0xFFFFFFFF:
        return QField(hd=field.hd, data=rel.astype(jnp.uint32), quant=quant)
    lo = (rel & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (rel >> jnp.uint64(32)).astype(jnp.uint32)
    return QField(hd=field.hd, data=lo, data_hi=hi, quant=quant)


def _dequantize_uint(qf: QField) -> Field:
    q: IntQuantization = qf.quant
    lo = jnp.asarray(qf.data).astype(jnp.uint64)
    if qf.data_hi is not None:
        lo = lo | (jnp.asarray(qf.data_hi).astype(jnp.uint64) <<
                   jnp.uint64(32))
    data = lo + jnp.uint64(q.x0)
    return Field(hd=qf.hd, data=data, acc=IntAccuracy())
