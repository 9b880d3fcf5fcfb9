"""Trim v1.0 -- the baseline "fast uniform" codec, frozen.

The reference specifies Trim as an algorithm code (types.h:15,
header_format.tex tab. 3) but never implements it; its intended inner loop
is the mock pipeline used by the reference's own tests and benchmarks
(test/compress_util_bench.c:234-298): bin indices -> uniform bitpack ->
LZ4.  Trim v1.0 realizes exactly that composition for all five field
types.

Per-field block layout (all blocks use the prelude of algos/blocks.py):

  POSN  meta | dimX | dimY | dimZ [| depths]     bins packed at `depth` bits
  VELC  meta | dimX | dimY | dimZ [| depths]
  PTID  meta | dimX | dimY | dimZ                per-dim width from range
  UNSF  meta | data [| depths]
  UNSI  meta | lo [| hi]                         planes split at 32 bits

meta payloads carry the field's Quantization (decode state, types.h:66-99)
including the dither seed, making every field self-decoding.  Block-level
damage is localized: a corrupt dimension block invalidates only that
dimension (returned as an invalid plane, surfaced as NaN by the segment
layer), per the spec's damage-localization design
(header_format.tex:186-196).

This module is FROZEN at v1.0: bug fixes that change the wire format must
go into a new algo_trim_v1_1.py (header_format.tex:278-283).
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import bitpack
from ..segment.stream import Reader, Writer
from ..types import (
    AlgoCode,
    Field,
    FieldCode,
    FieldHeader,
    FloatQuantization,
    IDQuantization,
    IntQuantization,
    PositionQuantization,
    QField,
    VelocityQuantization,
)
from . import registry
from .blocks import bits_needed, decode_block, encode_block

VERSION = semver.pack(1, 0, 0)


def _pack_plane(bins_dev, width: int) -> np.ndarray:
    """Device-side uniform bitpack of one plane of bins; returns host u32
    words."""
    packed = bitpack.uniform_pack(jnp.asarray(bins_dev), width)
    return np.asarray(packed)


def _unpack_plane(words: np.ndarray, width: int, n: int):
    """Host words -> device unpack -> u32 bins."""
    return bitpack.uniform_unpack(jnp.asarray(words), width, n)


def _pack_plane_var(bins_dev, depths: np.ndarray) -> np.ndarray:
    n_words = bitpack.var_packed_words(depths)
    packed = bitpack.pack(jnp.asarray(bins_dev), jnp.asarray(depths), n_words)
    return np.asarray(packed)


def _unpack_plane_var(words: np.ndarray, depths: np.ndarray):
    return bitpack.unpack(jnp.asarray(words), jnp.asarray(depths))


def _payload_words(payload: np.ndarray) -> np.ndarray:
    return np.frombuffer(payload.tobytes(), dtype="<u4").astype(
        np.uint32, copy=False)


def _unmap_eager(y, mode: int, threshold: float):
    """Device-side inverse float mapping for the fused decode path.

    Deliberately *eager* (op-by-op), exactly like the generic engine path
    after ``undo_float_uniform``: under jit, XLA constant-combines
    ``y * log2(10) * ln2`` inside the fused exp2 into one rounding, which
    shifts ~ULP bits vs the frozen eager decode digests.  Eager mul/exp2
    match the generic composition bit-for-bit."""
    from ..quant.engine import unmap_float
    return unmap_float(y, mode, threshold)


def _undo_var_fused(bins, depths, key, x0, x1, periodic_width=None,
                    unmap_mode: int = 0, threshold: float = 0.0):
    """Fused Deltas-mode undo: the exact generic composition --
    ``undo_float_var`` (the same standalone jitted program the engine
    runs) followed by eager unmap / periodic rewrap -- skipping the
    QField materialization.  Bit-identical to decompress + dequantize."""
    from ..ops import kernels
    from ..quant import engine
    y = engine.undo_float_var(bins, x0, x1, jnp.asarray(depths), key)
    if unmap_mode:
        y = engine.unmap_float(y, unmap_mode, threshold)
    if periodic_width is not None:
        y = kernels.periodic(y, periodic_width)
    return y


class TrimV1_0:
    algo_code = int(AlgoCode.TRIM)
    version = VERSION

    def __init__(self, accel: int = 1, try_entropy: bool = True):
        self.accel = accel
        self.try_entropy = try_entropy

    # -- plane hooks (overridden by derived codecs, e.g. Diff) -------------

    def _encode_plane(self, bins, depth: int):
        """One plane of bins -> (packed u32 words, stored width).  Trim
        packs raw bins at ``depth`` bits."""
        return _pack_plane(bins, depth), depth

    def _decode_plane(self, words: np.ndarray, width: int, n: int):
        """Inverse of _encode_plane.  Returns a DEVICE array: bins stay on
        device through dequantization so only the final floats cross the
        (slow) device->host link once."""
        return _unpack_plane(words, width, n)

    def _encode_plane_var(self, bins, depths: np.ndarray):
        """Per-particle-depth plane (Deltas mode): v1.0 packs exact
        per-element widths (contiguous bitstream)."""
        return _pack_plane_var(bins, depths), 0

    def _decode_plane_var(self, words: np.ndarray, depths: np.ndarray,
                          n: int):
        return _unpack_plane_var(words, depths)

    # -- compress ----------------------------------------------------------

    def compress(self, qf: QField) -> List[bytes]:
        code = qf.hd.field_code
        if code == FieldCode.POSN:
            return self._compress_3dim_float(qf, is_pos=True)
        if code == FieldCode.VELC:
            return self._compress_3dim_float(qf, is_pos=False)
        if code == FieldCode.PTID:
            return self._compress_id(qf)
        if code == FieldCode.UNSF:
            return self._compress_ufloat(qf)
        if code == FieldCode.UNSI:
            return self._compress_uint(qf)
        raise ValueError(f"unrecognized field code {code:#x}")

    def _compress_3dim_float(self, qf: QField, is_pos: bool) -> List[bytes]:
        q = qf.quant
        w = Writer()
        for v in q.x0:
            w.f32(v)
        for v in q.x1:
            w.f32(v)
        if is_pos:
            w.f32(q.width)
        w.u8(q.depth)
        w.u8(0 if q.depths is None else 1)
        if not is_pos:
            w.u8(q.sym_log10_scaled)
            w.u8(0)
            w.f32(q.sym_log10_threshold)
        else:
            w.u16(0)
        w.u64(q.seed)
        blocks = [encode_block(w.data, 0, self.try_entropy, self.accel)]

        bins = np.asarray(qf.data).reshape(3, -1) if isinstance(
            qf.data, np.ndarray) else qf.data.reshape(3, -1)
        for i in range(3):
            if q.depths is None:
                words, wstore = self._encode_plane(bins[i], q.depth)
                blocks.append(encode_block(words, wstore, self.try_entropy,
                                           self.accel))
            else:
                words, wstore = self._encode_plane_var(bins[i], q.depths)
                blocks.append(encode_block(words, wstore, self.try_entropy,
                                           self.accel))
        if q.depths is not None:
            blocks.append(encode_block(
                np.asarray(q.depths, dtype=np.uint8), 8, self.try_entropy,
                self.accel))
        return blocks

    def _compress_id(self, qf: QField) -> List[bytes]:
        q: IDQuantization = qf.quant
        w = Writer()
        w.u64(q.width)
        for v in q.x0:
            w.u64(v)
        for v in q.x1:
            w.u64(v)
        blocks = [encode_block(w.data, 0, self.try_entropy, self.accel)]
        bins = qf.data.reshape(3, -1)
        for i in range(3):
            width = bits_needed(q.x1[i] - q.x0[i])
            words, wstore = self._encode_plane(bins[i], width)
            blocks.append(encode_block(words, wstore, self.try_entropy,
                                       self.accel))
        return blocks

    def _compress_ufloat(self, qf: QField) -> List[bytes]:
        q: FloatQuantization = qf.quant
        w = Writer()
        w.f32(q.x0).f32(q.x1)
        w.u8(q.depth)
        w.u8(0 if q.depths is None else 1)
        w.u8(q.log10_scaled)
        w.u8(0)
        w.f32(q.sym_log10_threshold)
        w.u64(q.seed)
        blocks = [encode_block(w.data, 0, self.try_entropy, self.accel)]
        bins = qf.data.reshape(-1)
        if q.depths is None:
            words, wstore = self._encode_plane(bins, q.depth)
            blocks.append(encode_block(words, wstore, self.try_entropy,
                                       self.accel))
        else:
            words, wstore = self._encode_plane_var(bins, q.depths)
            blocks.append(encode_block(words, wstore, self.try_entropy,
                                       self.accel))
            blocks.append(encode_block(
                np.asarray(q.depths, dtype=np.uint8), 8, self.try_entropy,
                self.accel))
        return blocks

    def _compress_uint(self, qf: QField) -> List[bytes]:
        q: IntQuantization = qf.quant
        w = Writer()
        w.u64(q.x0).u64(q.x1)
        blocks = [encode_block(w.data, 0, self.try_entropy, self.accel)]
        rng = q.x1 - q.x0
        lo_width = min(32, bits_needed(rng))
        words, wstore = self._encode_plane(qf.data.reshape(-1), lo_width)
        blocks.append(encode_block(words, wstore, self.try_entropy,
                                   self.accel))
        if rng > 0xFFFFFFFF:
            hi_width = bits_needed(rng >> 32)
            words_hi = _pack_plane(qf.data_hi.reshape(-1), hi_width)
            blocks.append(encode_block(words_hi, hi_width, self.try_entropy,
                                       self.accel))
        return blocks

    # -- fused decompress (optional fast path) -----------------------------

    def decompress_field_fused(self, hd: FieldHeader,
                               blocks: List[Optional[bytes]],
                               field_index: int):
        """words -> Field in one fused device pipeline (unpack + dither +
        undo + rewrap, ``ops.fastpath``), skipping the QField bins
        materialization.  Returns None when the field is ineligible
        (non-Trim plane coding, per-particle depths, log scaling, corrupt
        blocks) -- callers fall back to the generic path.  Output bits are
        identical to decompress + dequantize (same dither spec and keys).
        """
        code = hd.field_code
        if type(self)._decode_plane is not TrimV1_0._decode_plane:
            return None  # derived codec changed the plane wire
        if code not in (FieldCode.POSN, FieldCode.VELC, FieldCode.UNSF):
            return None
        if any(b is None for b in blocks) or not blocks:
            return None
        from ..ops import fastpath
        from ..ops import rng as _rng
        from ..quant.engine import depth_to_delta
        from ..types import (FloatAccuracy, PositionAccuracy,
                             VelocityAccuracy)

        def plane(words, key, depth, x0v, dxv, box, periodic):
            return fastpath.fast_uniform_decode(
                words, key, depth, n, x0v, dxv,
                periodic_width=(box if periodic else None))

        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        if code == FieldCode.UNSF:
            from ..quant.engine import depths_to_deltas
            x0 = r.f32()
            x1 = r.f32()
            depth = r.u8()
            has_depths = r.u8()
            log10_scaled = r.u8()
            r.u8()
            threshold = r.f32()
            seed = r.u64()
            key = _rng.field_key_arr(seed, field_index, 0)
            if has_depths:
                if len(blocks) < 3 or blocks[2] is None:
                    return None
                dp, _, _ = decode_block(blocks[2])
                depths = np.asarray(dp, dtype=np.uint8)
                payload, w, _ = decode_block(blocks[1])
                bins = self._decode_plane_var(_payload_words(payload),
                                              depths, n)
                x = _undo_var_fused(jnp.asarray(bins), depths, key,
                                  float(x0), float(x1),
                                  unmap_mode=int(log10_scaled),
                                  threshold=float(threshold))
                acc = FloatAccuracy(
                    delta=0.0, deltas=depths_to_deltas(depths, x0, x1),
                    log10_scaled=log10_scaled,
                    sym_log10_threshold=threshold)
                return Field(hd=hd, data=x, acc=acc)
            if depth < 1 or n < 32 or len(blocks) < 2:
                return None
            payload, w, _ = decode_block(blocks[1])
            words = jnp.asarray(_payload_words(payload))
            x = plane(words, key, depth, x0,
                      np.float32(x1) - np.float32(x0), 0.0, False)
            if log10_scaled:
                # Same elementwise composition as the generic path
                # (unmap after undo); stays on device, fuses into the
                # decode consumers.
                x = _unmap_eager(x, log10_scaled, float(threshold))
            acc = FloatAccuracy(delta=depth_to_delta(depth, x0, x1),
                                log10_scaled=log10_scaled,
                                sym_log10_threshold=threshold)
            return Field(hd=hd, data=x, acc=acc)

        is_pos = code == FieldCode.POSN
        x0 = tuple(r.f32() for _ in range(3))
        x1 = tuple(r.f32() for _ in range(3))
        symlog, threshold = 0, 0.0
        width = 0.0
        if is_pos:
            width = r.f32()
        depth = r.u8()
        has_depths = r.u8()
        if not is_pos:
            symlog = r.u8()
            r.u8()
            threshold = r.f32()
        else:
            r.u16()
        seed = r.u64()
        x0a = np.asarray(x0, dtype=np.float32)
        x1a = np.asarray(x1, dtype=np.float32)
        max_diff = float(np.float32(np.max(x1a - x0a)))
        if has_depths:
            from ..quant.engine import depths_to_deltas
            if len(blocks) < 5 or blocks[4] is None:
                return None
            dp, _, _ = decode_block(blocks[4])
            depths = np.asarray(dp, dtype=np.uint8)
            dims = []
            for d in range(3):
                payload, w, _ = decode_block(blocks[1 + d])
                bins = self._decode_plane_var(_payload_words(payload),
                                              depths, n)
                key = _rng.field_key_arr(seed, field_index, d)
                dims.append(_undo_var_fused(
                    jnp.asarray(bins), depths, key, float(x0a[d]),
                    float(x0a[d]) + max_diff,
                    periodic_width=(width if is_pos else None),
                    unmap_mode=int(symlog), threshold=float(threshold)))
            data = jnp.stack(dims)
            deltas = depths_to_deltas(depths, x0a[0], x0a[0] + max_diff)
            if is_pos:
                acc = PositionAccuracy(delta=0.0, width=width,
                                       deltas=deltas)
            else:
                acc = VelocityAccuracy(delta=0.0, deltas=deltas,
                                       sym_log10_scaled=symlog,
                                       sym_log10_threshold=threshold)
            return Field(hd=hd, data=data, acc=acc)
        if depth < 1 or n < 32 or len(blocks) < 4:
            return None
        dims = []
        for d in range(3):
            payload, w, _ = decode_block(blocks[1 + d])
            words = jnp.asarray(_payload_words(payload))
            key = _rng.field_key_arr(seed, field_index, d)
            # Canonical bin width is f32(x0 + maxDiff) - f32(x0) (the
            # generic engine path, which the frozen decode digests pin);
            # passing maxDiff directly differs by 1 ULP for offset ranges.
            dx_eff = float(np.float32(float(x0a[d]) + max_diff) - x0a[d])
            y = plane(words, key, depth, float(x0a[d]), dx_eff,
                      width if is_pos else 0.0, is_pos)
            if symlog:
                y = _unmap_eager(y, symlog, float(threshold))
            dims.append(y)
        data = jnp.stack(dims)
        if is_pos:
            acc = PositionAccuracy(
                delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff),
                width=width)
        else:
            acc = VelocityAccuracy(
                delta=depth_to_delta(depth, x0a[0], x0a[0] + max_diff),
                sym_log10_scaled=symlog, sym_log10_threshold=threshold)
        return Field(hd=hd, data=data, acc=acc)

    # -- decompress --------------------------------------------------------

    def decompress(self, hd: FieldHeader,
                   blocks: List[Optional[bytes]]) -> QField:
        code = hd.field_code
        if blocks[0] is None:
            # Metadata loss cannot be localized -- whole field invalid
            # (spec allows but does not require partial recovery,
            # header_format.tex:190-193).
            return QField(hd=hd, data=None, quant=None, valid=False)
        if code == FieldCode.POSN:
            return self._decompress_3dim_float(hd, blocks, is_pos=True)
        if code == FieldCode.VELC:
            return self._decompress_3dim_float(hd, blocks, is_pos=False)
        if code == FieldCode.PTID:
            return self._decompress_id(hd, blocks)
        if code == FieldCode.UNSF:
            return self._decompress_ufloat(hd, blocks)
        if code == FieldCode.UNSI:
            return self._decompress_uint(hd, blocks)
        raise ValueError(f"unrecognized field code {code:#x}")

    def _decompress_3dim_float(self, hd: FieldHeader, blocks, is_pos: bool
                               ) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = tuple(r.f32() for _ in range(3))
        x1 = tuple(r.f32() for _ in range(3))
        if is_pos:
            width = r.f32()
        depth = r.u8()
        has_depths = r.u8()
        if not is_pos:
            symlog = r.u8()
            r.u8()
            threshold = r.f32()
        else:
            r.u16()
        seed = r.u64()

        depths = None
        if has_depths:
            if len(blocks) < 5 or blocks[4] is None:
                return QField(hd=hd, data=None, quant=None, valid=False)
            dp, _, _ = decode_block(blocks[4])
            depths = np.asarray(dp, dtype=np.uint8)

        dims = []
        dim_valid = []
        for i in range(3):
            blk = blocks[1 + i] if len(blocks) > 1 + i else None
            if blk is None:
                dims.append(jnp.zeros(n, dtype=jnp.uint32))
                dim_valid.append(False)
                continue
            payload, w, _ = decode_block(blk)
            words = _payload_words(payload)
            if depths is None:
                dims.append(self._decode_plane(words, w, n))
            else:
                dims.append(self._decode_plane_var(words, depths, n))
            dim_valid.append(True)
        data = jnp.stack([jnp.asarray(d) for d in dims])

        if is_pos:
            quant = PositionQuantization(x0=x0, x1=x1, width=width,
                                         depth=depth, depths=depths,
                                         seed=seed)
        else:
            quant = VelocityQuantization(x0=x0, x1=x1, depth=depth,
                                         depths=depths,
                                         sym_log10_scaled=symlog,
                                         sym_log10_threshold=threshold,
                                         seed=seed)
        qf = QField(hd=hd, data=data, quant=quant, valid=all(dim_valid))
        qf.dim_valid = tuple(dim_valid)
        return qf

    def _decompress_id(self, hd: FieldHeader, blocks) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        width = r.u64()
        x0 = tuple(r.u64() for _ in range(3))
        x1 = tuple(r.u64() for _ in range(3))
        dims = []
        dim_valid = []
        for i in range(3):
            blk = blocks[1 + i] if len(blocks) > 1 + i else None
            if blk is None:
                dims.append(jnp.zeros(n, dtype=jnp.uint32))
                dim_valid.append(False)
                continue
            payload, w, _ = decode_block(blk)
            dims.append(self._decode_plane(_payload_words(payload), w, n))
            dim_valid.append(True)
        quant = IDQuantization(width=width, x0=x0, x1=x1)
        qf = QField(hd=hd, data=jnp.stack([jnp.asarray(d) for d in dims]),
                    quant=quant, valid=all(dim_valid))
        qf.dim_valid = tuple(dim_valid)
        return qf

    def _decompress_ufloat(self, hd: FieldHeader, blocks) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = r.f32()
        x1 = r.f32()
        depth = r.u8()
        has_depths = r.u8()
        log10_scaled = r.u8()
        r.u8()
        threshold = r.f32()
        seed = r.u64()
        depths = None
        if has_depths:
            if len(blocks) < 3 or blocks[2] is None:
                return QField(hd=hd, data=None, quant=None, valid=False)
            dp, _, _ = decode_block(blocks[2])
            depths = np.asarray(dp, dtype=np.uint8)
        quant = FloatQuantization(x0=x0, x1=x1, depth=depth, depths=depths,
                                  log10_scaled=log10_scaled,
                                  sym_log10_threshold=threshold, seed=seed)
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        payload, w, _ = decode_block(blocks[1])
        words = _payload_words(payload)
        if depths is None:
            data = self._decode_plane(words, w, n)
        else:
            data = self._decode_plane_var(words, depths, n)
        return QField(hd=hd, data=data, quant=quant)

    def _decompress_uint(self, hd: FieldHeader, blocks) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = r.u64()
        x1 = r.u64()
        quant = IntQuantization(x0=x0, x1=x1)
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        payload, w, _ = decode_block(blocks[1])
        data = self._decode_plane(_payload_words(payload), w, n)
        data_hi = None
        if x1 - x0 > 0xFFFFFFFF:
            if len(blocks) < 3 or blocks[2] is None:
                return QField(hd=hd, data=None, quant=quant, valid=False)
            payload_hi, w_hi, _ = decode_block(blocks[2])
            data_hi = np.asarray(
                _unpack_plane(_payload_words(payload_hi), w_hi, n))
        return QField(hd=hd, data=data, quant=quant, data_hi=data_hi)


registry.register(TrimV1_0())
