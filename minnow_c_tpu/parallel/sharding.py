"""Data-parallel scale-out over device meshes.

The reference assigns multi-node parallelism to the client and keeps
segments as the decomposition unit (doc/separation_of_duties.md:7-12,
header_format.tex:120-135): segments are independent by construction, each
self-describing.  This module realizes that contract on a device mesh: a snapshot is split into fixed-size particle blocks, blocks are
sharded across a ``jax.sharding.Mesh`` data-parallel axis, and the whole
quantize->bin->pack pipeline runs as one SPMD program under ``shard_map``.
Compressed streams are gathered to the host in file order; per-block
quantization headers ride along as tiny sharded arrays.

Two encode profiles:

* ``spmd`` (single-pass): bit depth is derived *statically* from the
  accuracy request and the periodic box width (range <= box width), so the
  entire encode is one jitted SPMD program with no host sync.  Files are
  slightly larger when data occupies less than the full box.
* ``adaptive`` (two-phase): a sharded stats pass computes per-block ranges,
  one scalar sync derives the tightest shared depth (max over blocks via an
  all-reduce), then a second SPMD pass bins and packs at that static depth.
  Matches the reference's data-driven depth choice (quant.c:195).

RNG parity: per-block decode dithering uses ``fold_in(seed, block)`` --
the counter-based replacement for the reference's jump-separated parallel
streams (rand.c:93-112).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bitpack, kernels
from ..ops import rng as _rng
from ..quant import engine


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    # Auto axis type, NOT jax.make_mesh's Explicit default: this codebase
    # shards via shard_map (specs given at the call), and an Explicit
    # mesh makes every array sharded over it carry an explicit
    # PartitionSpec in its aval.
    return jax.make_mesh((len(devs),), (axis,), devices=np.array(devs),
                         axis_types=(jax.sharding.AxisType.Auto,))


def block_split(x: np.ndarray, num_blocks: int) -> np.ndarray:
    """Reshape (3, n) or (n,) particle data into (num_blocks, ..., n_b).
    n must divide evenly; the client pads ragged tails (segmenting is the
    client's duty, spec table 1)."""
    if x.ndim == 1:
        n = x.shape[0]
        assert n % num_blocks == 0, "particle count must divide into blocks"
        return x.reshape(num_blocks, n // num_blocks)
    n = x.shape[1]
    assert n % num_blocks == 0, "particle count must divide into blocks"
    return np.moveaxis(x.reshape(x.shape[0], num_blocks, n // num_blocks),
                       1, 0)


# ---------------------------------------------------------------------------
# SPMD position pipeline (the flagship path)
# ---------------------------------------------------------------------------
# Shared SPMD building blocks (one implementation serves both codecs below,
# making the "snapshot-codec position bits == position-codec bits" invariant
# structural rather than test-enforced)
# ---------------------------------------------------------------------------


def _rows_stats_raw(rows, box):
    """Per-row stats of (R, n) independent streams: (min (R,),
    max (R,)) of the periodically-unwrapped rows (``box`` None: no
    unwrap)."""
    def one(r):
        u = kernels.undo_periodic(r, box) if box is not None else r
        return jnp.min(u), jnp.max(u)
    return jax.vmap(one)(rows)


def _rows_encode_recip_raw(rows, x0r, rng_r, depth: int, box):
    """Recip-mode encode of (R, n) independent rows (32 | n) with per-row
    x0 and range: the anchored recip bin map (kernels.recip_bins) and the
    rows pack."""
    periodic = box is not None
    boxf = jnp.float32(box if periodic else 0.0)
    recip_r = kernels.exact_recip(rng_r)
    bins = jax.vmap(lambda r, o, rc: kernels.recip_bins(
        r, o, rc, boxf, r[0], depth, periodic))(rows, x0r, recip_r)
    bins = jax.lax.optimization_barrier(bins)
    return bitpack.uniform_pack_rows(bins, depth)


def _float_rows_encode_recip(x, x0, rng_b, depth: int, box):
    """Recip-mode encode of (B_local, D, n_b) RAW floats (32 | n_b) at the
    block-shared range ``rng_b`` straight to (B_local, D, words)."""
    b_l, nd, n_b = x.shape
    words = _rows_encode_recip_raw(
        x.reshape(b_l * nd, n_b), x0.reshape(b_l * nd),
        jnp.repeat(rng_b, nd), depth, box)
    return words.reshape(b_l, nd, -1)


def _rows_encode_div_raw(rows, x0r, rng_r, depth: int, box):
    """Div-mode (C-exact) encode of (R, n) rows: recomputed anchored
    unwrap (the stats pass does not hand its unwrapped plane over, which
    would cost a write and re-read of device memory) + per-row bin at the
    block-shared range + rows pack."""
    periodic = box is not None

    def unwrap(v):
        if not periodic:
            return v
        return jax.vmap(lambda r: kernels.undo_periodic(r, box))(v)

    u2 = unwrap(jax.lax.optimization_barrier(rows))
    bins = jax.vmap(
        lambda rd, o, rg: kernels.uniform_bin_index(rd, depth, o, rg))(
            u2, x0r, rng_r)
    bins = jax.lax.optimization_barrier(bins)
    return bitpack.uniform_pack_rows(bins, depth)


def _block_keys(seed_arr, block_idx):
    """Dither keys for blocks x 3 dims: (B_local,) -> (B_local, 3, 2)."""
    return jax.vmap(lambda bi: jnp.stack(
        [_rng.field_key_jax(seed_arr[0], bi, d) for d in range(3)]))(
            block_idx)


def _float_rows_decode(words, x0, rng_b, keys, depth: int, n_b: int,
                       box, periodic: bool):
    """Dithered decode of (B_local, 3, n_words) packed streams back to
    (B_local, 3, n_b) floats; per-(block, dim) keys in ``keys``
    (B_local, 3, 2)."""
    def one_block(wb, x0b, rb, kb):
        def one_dim(wd, o, key):
            bins = bitpack.uniform_unpack(wd, depth, n_b)
            # Barrier: keeps the unpack out of the float consumers'
            # fusion (see ops/fastpath.py).
            bins = jax.lax.optimization_barrier(bins)
            dx = rb / jnp.float32(1 << depth)
            u = _rng.uniform24(key, bins.shape)
            x = o + dx * (bins.astype(jnp.float32) + u)
            x = jax.lax.optimization_barrier(x)
            return kernels.periodic(x, box) if periodic else x

        return jnp.stack([one_dim(wb[d], x0b[d], kb[d])
                          for d in range(3)])

    return jax.vmap(one_block)(words, x0, rng_b, keys)


class _MeshCodecBase:
    """Input sharding shared by the SPMD codecs."""

    def _in_shardings(self):
        return NamedSharding(self.mesh, P(self.axis))

    @staticmethod
    def _check_aligned(n_b: int):
        if n_b % 32:
            raise ValueError(
                f"block size {n_b} is not a multiple of 32; pad blocks "
                "to 32 particles (segment padding is the client's duty, "
                "header_format.tex table 1) -- misaligned packs would "
                "decode to a wrong-length block")


@dataclass(frozen=True)
class ShardedPositionCodec(_MeshCodecBase):
    """Block-sharded position codec over a device mesh.

    ``encode`` maps (B, 3, n_b) f32 positions to packed u32 words plus
    per-block headers (x0, range); ``decode`` inverts it.  Both are single
    jitted SPMD programs; the static ``depth`` comes from the accuracy
    request (spmd profile) or the adaptive stats pass.
    """

    mesh: Mesh
    width: float  # periodic box width
    depth: int  # bits per value
    axis: str = "dp"
    # Bin-map choice: 'div' = the C-exact division map
    # (kernels.uniform_bin_index); 'recip' = the reciprocal map
    # (kernels.uniform_bin_index_recip), a multiplication in place of a
    # per-element division.  Wire-compatible either way (decode never
    # recomputes the map); headers are identical.
    scale_mode: str = "div"

    def __post_init__(self):
        if self.scale_mode not in ("div", "recip"):
            raise ValueError(f"unknown scale_mode {self.scale_mode!r}")

    @property
    def _spec_blocks(self):
        return P(self.axis)

    @functools.cached_property
    def _encode(self):
        width, depth, axis = self.width, self.depth, self.axis

        def encode_local(rows):  # rows: (B_local*3, n_b), block-major
            # Device boundary is ROW-MAJOR (B*3, n): the stats, bin and
            # pack all work on rows, so the streams keep one layout end
            # to end and only O(B) header arrays reshape.
            r3 = rows.shape[0]
            b_l = r3 // 3
            mn, mx = _rows_stats_raw(rows, width)
            x0 = mn.reshape(b_l, 3)
            rng_b = jnp.max((mx - mn).reshape(b_l, 3), axis=1)
            rng_r = jnp.repeat(rng_b, 3)
            if self.scale_mode == "recip":
                words = _rows_encode_recip_raw(rows, mn, rng_r, depth, width)
            else:
                words = _rows_encode_div_raw(rows, mn, rng_r, depth, width)
            return words, x0, rng_b

        return jax.jit(jax.shard_map(
            encode_local, mesh=self.mesh,
            in_specs=P(axis), out_specs=(P(axis), P(axis), P(axis))))

    @functools.cached_property
    def _decode(self):
        width, depth, axis = self.width, self.depth, self.axis

        def decode_local(words, x0, rng_b, seed_arr, block0):
            # words: (B_local*3, n_words) block-major rows (see
            # encode_local's layout note); block0: local base block index
            r3 = words.shape[0]
            b_l, n_words = r3 // 3, words.shape[1]
            n_b = (n_words * 32) // depth if depth else 0
            idx = jax.lax.axis_index(axis) * b_l + jnp.arange(b_l)
            keys = _block_keys(seed_arr, idx)  # (B_local, 3, 2)
            out = _float_rows_decode(
                words.reshape(b_l, 3, n_words), x0, rng_b, keys, depth,
                n_b, width, True)
            return out.reshape(r3, n_b)

        return jax.jit(jax.shard_map(
            decode_local, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P()),
            out_specs=P(axis)))

    @staticmethod
    def _rows(x):
        """(B, 3, n) -> (B*3, n) block-major rows; rows inputs pass
        through.  Free for numpy; device arrays should be built in rows
        form to begin with (a committed-array reshape is a compiled
        relayout)."""
        if x.ndim == 3:
            return x.reshape(x.shape[0] * x.shape[1], x.shape[2])
        return x

    def encode(self, x):
        """x: (B, 3, n_b) f32 (or rows (B*3, n_b)), B divisible by mesh
        size, 32 | n_b.  Returns (words (B*3, W) block-major rows,
        x0 (B, 3), range (B,)) device arrays, block-sharded (see
        ``_encode`` on the rows boundary); reshape with
        ``.reshape(B, 3, -1)`` for per-(block, dim) streams."""
        if x.ndim == 3:
            self._check_aligned(x.shape[2])
        else:
            self._check_aligned(x.shape[1])
        sh = self._in_shardings()
        x = jax.device_put(self._rows(x), sh)
        return self._encode(x)

    def decode(self, words, x0, rng_b, seed: int = 0):
        """Inverse of :meth:`encode`; returns (B*3, n_b) block-major
        rows of block-sharded floats (reshape to (B, 3, n_b) as
        needed)."""
        seed_arr = jnp.asarray([seed], dtype=jnp.uint32)
        return self._decode(self._rows(words), x0, rng_b, seed_arr,
                            jnp.zeros((1,), jnp.int32))

    # -- adaptive profile helpers ------------------------------------------

    @functools.cached_property
    def _stats(self):
        width, axis = self.width, self.axis

        def stats_local(xf):
            # rows (B_local*3, n) or (B_local, 3, n)
            x = xf.reshape(xf.shape[0] // 3, 3, xf.shape[1]) \
                if xf.ndim == 2 else xf

            def one_block(xb):
                xu = jax.vmap(
                    lambda d: kernels.undo_periodic(d, width))(xb)
                return jnp.max(jnp.max(xu, axis=1) - jnp.min(xu, axis=1))

            local = jax.vmap(one_block)(x)
            # All-reduce the max range across the mesh so every shard (and
            # the host) sees the same global header value.
            gmax = jax.lax.pmax(jnp.max(local), axis)
            return local, gmax

        return jax.jit(jax.shard_map(
            stats_local, mesh=self.mesh,
            in_specs=P(axis), out_specs=(P(axis), P())))

    def global_range(self, x) -> float:
        """Adaptive profile phase 1: the one scalar that syncs to host."""
        sh = self._in_shardings()
        x = jax.device_put(x, sh)
        _, gmax = self._stats(x)
        return float(np.asarray(gmax))


def spmd_depth_for(delta: float, width: float) -> int:
    """Static depth for the spmd profile: the range of any block never
    exceeds the box width, so this depth always satisfies ``delta``."""
    return engine.delta_to_depth(delta, 0.0, width)


def adaptive_depth_for(codec: ShardedPositionCodec, x, delta: float) -> int:
    """Tightest shared depth across blocks (one host sync)."""
    g = codec.global_range(x)
    return engine.delta_to_depth(delta, 0.0, g)


# ---------------------------------------------------------------------------
# Full-snapshot SPMD codec: positions + velocities + IDs in one program
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardedSnapshotCodec(_MeshCodecBase):
    """Block-sharded codec for a full standard snapshot (Posn + Velc +
    Ptid) over a device mesh -- the SPMD analog of the reference's
    canonical client segment (funcs.c:212-266: position delta=1e-3,
    velocity delta=1, ID grid width; multi-node parallelism being the
    client's duty per doc/separation_of_duties.md:7-12).

    ``encode``: (pos (B, 3, n_b) f32, vel (B, 3, n_b) f32,
    ids (B, n_b) u64) -> packed word streams + per-block headers, all
    block-sharded over the mesh axis.  ``decode`` inverts it: positions
    and velocities within their deltas (dithered), IDs bit-exact.  Both
    directions are single jitted SPMD programs with no host sync.

    Dither streams: block ``bi`` dim ``d`` of positions uses
    ``field_key(seed, bi, d)`` -- bit-identical to
    ``ShardedPositionCodec`` at the same seed (tested) -- and
    velocities use ``field_key(seed, B_total + bi, d)``, so no two
    (field, block, dim) streams collide.
    """

    mesh: Mesh
    box: float          # periodic box width (positions)
    pos_depth: int
    vel_depth: int
    id_grid: int        # Lagrangian ID grid width (IDAccuracy.width)
    axis: str = "dp"
    scale_mode: str = "div"  # see ShardedPositionCodec.scale_mode

    def __post_init__(self):
        if self.scale_mode not in ("div", "recip"):
            raise ValueError(f"unknown scale_mode {self.scale_mode!r}")
        if not (1 <= self.pos_depth <= 24) or not (1 <= self.vel_depth
                                                   <= 24):
            raise ValueError(
                f"float depths must be in [1, 24] (f32 mantissa cap, "
                f"quant.c:684-693); got pos={self.pos_depth} "
                f"vel={self.vel_depth}")
        if not (2 <= self.id_grid <= (1 << 21)):
            raise ValueError(
                f"id_grid must be in [2, 2^21] (grid^3 <= 2^64 and u32 "
                f"coordinate bins); got {self.id_grid}")

    @property
    def id_width(self) -> int:
        """Static bin width for ID grid coordinates: after the u64
        periodic unwrap + min-subtract the coords lie in [0, grid)."""
        return max(1, int(np.ceil(np.log2(self.id_grid))))

    @functools.cached_property
    def _encode(self):
        box, axis = self.box, self.axis
        pos_depth, vel_depth = self.pos_depth, self.vel_depth
        grid, id_width = self.id_grid, self.id_width

        def encode_local(pos_rows, vel_rows, ids):
            # pos_rows/vel_rows: (b_l*3, n_b) block-major rows (boundary
            # layout rule, see ShardedPositionCodec._encode)
            r3 = pos_rows.shape[0]
            b_l = r3 // 3

            def id_block(ib):  # id(), quant.c:291-327 -- lossless
                w = jnp.uint64(grid)
                dims = jnp.stack([ib % w, (ib // w) % w, ib // (w * w)])
                dims = jax.vmap(
                    lambda d: kernels.u64_undo_periodic(d, grid))(dims)
                x0 = jnp.min(dims, axis=1)
                return (dims - x0[:, None]).astype(jnp.uint32), x0

            ibins, ix0 = jax.vmap(id_block)(ids)
            # (b_l, 3, n_b) -> (r3, n_b): elementwise producer fuses into
            # the pack operand write -- no standalone regroup pass.
            ibins = ibins.reshape(r3, -1)
            iw = bitpack.uniform_pack_rows(ibins, id_width)

            def float_field(rows, depth, boxv):
                mn, mx = _rows_stats_raw(rows, boxv)
                x0 = mn.reshape(b_l, 3)
                rng_b = jnp.max((mx - mn).reshape(b_l, 3), axis=1)
                rng_r = jnp.repeat(rng_b, 3)
                if self.scale_mode == "recip":
                    w = _rows_encode_recip_raw(rows, mn, rng_r, depth, boxv)
                else:
                    w = _rows_encode_div_raw(rows, mn, rng_r, depth, boxv)
                return w, x0, rng_b

            pw, px0, prng = float_field(pos_rows, pos_depth, box)
            vw, vx0, vrng = float_field(vel_rows, vel_depth, None)
            return pw, px0, prng, vw, vx0, vrng, iw, ix0

        return jax.jit(jax.shard_map(
            encode_local, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=tuple([P(axis)] * 8)))

    @functools.cached_property
    def _decode(self):
        axis = self.axis
        pos_depth, vel_depth = self.pos_depth, self.vel_depth
        grid, id_width = self.id_grid, self.id_width

        def decode_local(pw, px0, prng, vw, vx0, vrng, iw, ix0,
                         seed_arr):
            # (b_l*3, W) block-major word rows in, (b_l*3, n_b) float
            # rows + (b_l, n_b) ids out (boundary layout rule, see
            # ShardedPositionCodec)
            r3 = pw.shape[0]
            b_l = r3 // 3
            n_b = (pw.shape[1] * 32) // pos_depth if pos_depth else 0
            b_total = b_l * jax.lax.psum(1, axis)
            bi = jax.lax.axis_index(axis) * b_l + jnp.arange(b_l)
            pkeys = _block_keys(seed_arr, bi)
            vkeys = _block_keys(seed_arr, b_total + bi)

            def float_rows(words, x0, rng_b, keys, depth, boxv, periodic):
                out = _float_rows_decode(
                    words.reshape(b_l, 3, -1), x0, rng_b, keys, depth,
                    n_b, boxv, periodic)
                return out.reshape(r3, n_b)

            pos = float_rows(pw, px0, prng, pkeys, pos_depth, self.box,
                             True)
            vel = float_rows(vw, vx0, vrng, vkeys, vel_depth, None,
                             False)

            # IDs: unpack + recompose (undoID, quant.c:553-587), exact.
            ibins = jax.vmap(jax.vmap(
                lambda wd: bitpack.uniform_unpack(wd, id_width, n_b)
            ))(iw.reshape(b_l, 3, -1))
            w = jnp.uint64(grid)
            dims = ibins.astype(jnp.uint64) + ix0[:, :, None]
            dims = jnp.where(dims >= w, dims - w, dims)
            ids = dims[:, 0] + w * dims[:, 1] + w * w * dims[:, 2]
            return pos, vel, ids

        return jax.jit(jax.shard_map(
            decode_local, mesh=self.mesh,
            in_specs=tuple([P(axis)] * 8) + (P(),),
            out_specs=(P(axis), P(axis), P(axis))))

    def encode(self, pos, vel, ids):
        """pos/vel: (B, 3, n_b) f32 (or rows (B*3, n_b)); ids (B, n_b)
        u64.  Returns the 8-tuple (pw, px0, prng, vw, vx0, vrng, iw,
        ix0) with (B*3, W) block-major row word streams (see
        ShardedPositionCodec.encode on the rows boundary rule)."""
        if pos.ndim == 3:
            self._check_aligned(pos.shape[2])
        else:
            self._check_aligned(pos.shape[1])
        sh = self._in_shardings()
        rows = ShardedPositionCodec._rows
        return self._encode(jax.device_put(rows(pos), sh),
                            jax.device_put(rows(vel), sh),
                            jax.device_put(ids, sh))

    def decode(self, enc, seed: int = 0):
        """``enc`` is the 8-tuple from :meth:`encode`; returns
        (pos (B*3, n_b) rows, vel (B*3, n_b) rows, ids (B, n_b))
        block-sharded device arrays."""
        seed_arr = jnp.asarray([seed], dtype=jnp.uint32)
        rows = ShardedPositionCodec._rows
        enc = (rows(enc[0]),) + tuple(enc[1:3]) + (rows(enc[3]),) + \
            tuple(enc[4:6]) + (rows(enc[6]),) + (enc[7],)
        return self._decode(*enc, seed_arr)
