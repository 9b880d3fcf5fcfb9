"""Octo v1.0 -- octree/Morton hierarchical codec for 3-dim fields, frozen.

Realizes the spec'd Octo algorithm code (header_format.tex tab. 3;
unimplemented in the reference).  For a 3-dimensional field binned at
``depth`` bits per dim, each dim splits into:

* a k-bit *cell* coordinate (k = min(depth, 10)) -- the three cells are
  Morton-interleaved into one 3k-bit octree cell index whose stream is
  delta+zigzag coded and chunk-packed (Coil-style): in any spatially
  coherent order, consecutive particles share or neighbor cells, so the
  single interleaved stream compresses far better than three independent
  high-bit planes;
* a (depth-k)-bit within-cell offset, packed raw per dim.

Per-field blocks: ``meta | morton | loX | loY | loZ``.  Scalar fields and
per-particle-depth mode fall back to Coil plane coding (Octo derives from
Coil).  The ID field (Ptid) uses its per-dim widths, splitting each at the
same k rule.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp
import numpy as np

from .. import semver
from ..ops import bitpack
from ..segment.stream import Reader, Writer
from ..types import (
    AlgoCode,
    FieldHeader,
    PositionQuantization,
    QField,
    VelocityQuantization,
)
from . import registry
from .algo_coil_v1_0 import CoilV1_0
from .blocks import bits_needed, decode_block, encode_block

VERSION = semver.pack(1, 0, 0)
MAX_K = 10  # cell bits per dim; 3k must fit u32


def _part1by2(x):
    """Spread the low 10 bits of each u32 lane to every 3rd bit."""
    x = x & jnp.uint32(0x3FF)
    x = (x | (x << jnp.uint32(16))) & jnp.uint32(0x030000FF)
    x = (x | (x << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
    x = (x | (x << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
    x = (x | (x << jnp.uint32(2))) & jnp.uint32(0x09249249)
    return x


def _compact1by2(x):
    """Inverse of _part1by2."""
    x = x & jnp.uint32(0x09249249)
    x = (x | (x >> jnp.uint32(2))) & jnp.uint32(0x030C30C3)
    x = (x | (x >> jnp.uint32(4))) & jnp.uint32(0x0300F00F)
    x = (x | (x >> jnp.uint32(8))) & jnp.uint32(0x030000FF)
    x = (x | (x >> jnp.uint32(16))) & jnp.uint32(0x000003FF)
    return x


def morton3(cx, cy, cz):
    return _part1by2(cx) | (_part1by2(cy) << jnp.uint32(1)) | \
        (_part1by2(cz) << jnp.uint32(2))


def unmorton3(m):
    return (_compact1by2(m), _compact1by2(m >> jnp.uint32(1)),
            _compact1by2(m >> jnp.uint32(2)))


class OctoV1_0(CoilV1_0):
    algo_code = int(AlgoCode.OCTO)
    version = VERSION

    # -- 3-dim float fields (Posn/Velc) ------------------------------------

    def _compress_3dim_float(self, qf: QField, is_pos: bool) -> List[bytes]:
        q = qf.quant
        if q.depths is not None:
            return super()._compress_3dim_float(qf, is_pos)
        return self._compress_morton(qf, self._float_meta(q, is_pos),
                                     [q.depth] * 3)

    def _decompress_3dim_float(self, hd: FieldHeader, blocks, is_pos: bool
                               ) -> QField:
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
        if has_depths:
            return super()._decompress_3dim_float(hd, blocks, is_pos)
        if is_pos:
            quant = PositionQuantization(x0=x0, x1=x1, width=width,
                                         depth=depth, depths=None, seed=seed)
        else:
            quant = VelocityQuantization(x0=x0, x1=x1, depth=depth,
                                         depths=None,
                                         sym_log10_scaled=symlog,
                                         sym_log10_threshold=threshold,
                                         seed=seed)
        return self._decompress_morton(hd, blocks, quant, [depth] * 3)

    def _compress_id(self, qf: QField) -> List[bytes]:
        q = qf.quant
        w = Writer()
        w.u64(q.width)
        for v in q.x0:
            w.u64(v)
        for v in q.x1:
            w.u64(v)
        depths = [bits_needed(q.x1[i] - q.x0[i]) for i in range(3)]
        return self._compress_morton(qf, w.data, depths)

    def _decompress_id(self, hd: FieldHeader, blocks) -> QField:
        from ..types import IDQuantization
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        width = r.u64()
        x0 = tuple(r.u64() for _ in range(3))
        x1 = tuple(r.u64() for _ in range(3))
        quant = IDQuantization(width=width, x0=x0, x1=x1)
        depths = [bits_needed(x1[i] - x0[i]) for i in range(3)]
        return self._decompress_morton(hd, blocks, quant, depths)

    # -- Morton machinery --------------------------------------------------

    def _float_meta(self, q, is_pos: bool) -> bytes:
        w = Writer()
        for v in q.x0:
            w.f32(v)
        for v in q.x1:
            w.f32(v)
        if is_pos:
            w.f32(q.width)
        w.u8(q.depth)
        w.u8(0)
        if not is_pos:
            w.u8(q.sym_log10_scaled)
            w.u8(0)
            w.f32(q.sym_log10_threshold)
        else:
            w.u16(0)
        w.u64(q.seed)
        return w.data

    def _compress_morton(self, qf: QField, meta: bytes,
                         depths) -> List[bytes]:
        # Keep bins on device (qf.data is usually already a device
        # array from the quant engine; np round-trips cost full-array
        # transfers).
        bins = jnp.asarray(qf.data).reshape(3, -1).astype(jnp.uint32)
        k = min(MAX_K, max(depths))
        cell_bits = [min(k, d) for d in depths]
        lo_bits = [d - c for d, c in zip(depths, cell_bits)]
        cells = [bins[i] >> jnp.uint32(lo_bits[i]) for i in range(3)]
        lows = [bins[i] & ((jnp.uint32(1) << jnp.uint32(lo_bits[i])) -
                           jnp.uint32(1)) for i in range(3)]
        m = morton3(*cells)
        blocks = [encode_block(meta, 0, self.try_entropy, self.accel)]
        # Morton stream: Coil-style chunked delta coding; store via the
        # plane encoder (depth arg only caps widths, pass 32).  Virtual
        # dispatch: for OctoV1_0 instances self._encode_plane IS
        # CoilV1_0._encode_plane (not overridden), so v1.0 bytes are
        # unchanged (digest-tested); OctoV1_1 redirects to the v1.1
        # chunk layout.
        mwords, _ = self._encode_plane(m, 32)
        blocks.append(encode_block(mwords, 0, self.try_entropy, self.accel))
        for i in range(3):
            if lo_bits[i] == 0:
                blocks.append(encode_block(np.zeros(0, dtype=np.uint32),
                                           0, False))
                continue
            words = np.asarray(bitpack.uniform_pack(lows[i], lo_bits[i]))
            blocks.append(encode_block(words, lo_bits[i], self.try_entropy,
                                       self.accel))
        return blocks

    def _decompress_morton(self, hd: FieldHeader, blocks, quant,
                           depths) -> QField:
        n = hd.particle_len
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        k = min(MAX_K, max(depths))
        cell_bits = [min(k, d) for d in depths]
        lo_bits = [d - c for d, c in zip(depths, cell_bits)]

        from .algo_trim_v1_0 import _payload_words
        payload, _, _ = decode_block(blocks[1])
        m = jnp.asarray(self._decode_plane(_payload_words(payload), 0, n))
        cells = unmorton3(m)

        dims = []
        dim_valid = []
        for i in range(3):
            blk = blocks[2 + i] if len(blocks) > 2 + i else None
            if lo_bits[i] == 0:
                low = jnp.zeros(n, dtype=jnp.uint32)
                ok = True
            elif blk is None:
                low = jnp.zeros(n, dtype=jnp.uint32)
                ok = False
            else:
                p, wbits, _ = decode_block(blk)
                low = bitpack.uniform_unpack(
                    jnp.asarray(_payload_words(p)), wbits, n)
                ok = True
            # stays a device array: the quant engine dequantizes from
            # device, and only final floats cross the slow D2H link
            dims.append((cells[i] << jnp.uint32(lo_bits[i])) | low)
            dim_valid.append(ok)
        qf = QField(hd=hd, data=jnp.stack(dims), quant=quant,
                    valid=all(dim_valid))
        qf.dim_valid = tuple(dim_valid)
        return qf


registry.register(OctoV1_0())
