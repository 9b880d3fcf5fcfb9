"""Sharded codec tests on the virtual 8-device CPU mesh: SPMD round trips,
collective-derived headers, per-block dither independence, and scaling
sanity."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from minnow_c_tpu.parallel.sharding import (
    ShardedPositionCodec,
    adaptive_depth_for,
    block_split,
    make_mesh,
    spmd_depth_for,
)


W = 64.0


def make_blocks(B=16, nb=512, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, W, (B, 3, nb)).astype(np.float32)


class TestShardedPositionCodec:
    def test_eight_device_mesh(self):
        assert len(jax.devices()) >= 8, "conftest must provide 8 devices"
        mesh = make_mesh(8)
        depth = spmd_depth_for(1e-3, W)
        codec = ShardedPositionCodec(mesh=mesh, width=W, depth=depth)
        x = make_blocks()
        words, x0, rng_b = codec.encode(x)
        out = np.asarray(codec.decode(words, x0, rng_b,
                                      seed=5)).reshape(x.shape)
        err = np.abs(out - x)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_adaptive_depth_smaller(self):
        # Data occupying a fraction of the box needs fewer bits adaptively.
        mesh = make_mesh(4)
        rng = np.random.default_rng(1)
        x = rng.uniform(10.0, 14.0, (8, 3, 256)).astype(np.float32)
        codec = ShardedPositionCodec(mesh=mesh, width=W,
                                     depth=spmd_depth_for(1e-3, W))
        d_spmd = spmd_depth_for(1e-3, W)
        d_adapt = adaptive_depth_for(codec, x, 1e-3)
        assert d_adapt < d_spmd
        codec2 = ShardedPositionCodec(mesh=mesh, width=W, depth=d_adapt)
        words, x0, rng_b = codec2.encode(x)
        out = np.asarray(codec2.decode(words, x0,
                                       rng_b)).reshape(x.shape)
        err = np.abs(out - x)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_blocks_dither_independently(self):
        mesh = make_mesh(2)
        codec = ShardedPositionCodec(mesh=mesh, width=W,
                                     depth=spmd_depth_for(1e-2, W))
        x = np.tile(make_blocks(B=1, nb=256), (4, 1, 1))  # identical blocks
        words, x0, rng_b = codec.encode(x)
        out = np.asarray(codec.decode(words, x0, rng_b,
                                      seed=3)).reshape(x.shape)
        # same bins everywhere, but block dither keys differ
        assert not np.array_equal(out[0], out[1])

    def test_decode_matches_segment_decode(self):
        """Each (block, dim) stream decodes to the values the per-segment
        fast path gives for that stream, under the block's global key
        (one rounding apart at most: either program may contract
        x0 + dx*t into an FMA)."""
        from minnow_c_tpu.ops import fastpath
        from minnow_c_tpu.ops import rng as _rng
        mesh = make_mesh(8)
        depth = spmd_depth_for(1e-3, W)
        B, nb = 16, 512
        x = make_blocks(B=B, nb=nb, seed=7)
        codec = ShardedPositionCodec(mesh=mesh, width=W, depth=depth)
        words, x0, rng_b = codec.encode(x)
        got = np.asarray(codec.decode(words, x0, rng_b,
                                      seed=5)).reshape(B, 3, nb)
        w = np.asarray(words).reshape(B, 3, -1)
        x0h, rh = np.asarray(x0), np.asarray(rng_b)
        for b in (0, 5, 15):
            for d in range(3):
                key = np.asarray(_rng.field_key(5, b, d), np.uint32)
                ref = np.asarray(fastpath.fast_uniform_decode(
                    jnp.asarray(w[b, d]), key, depth, nb, x0h[b, d], rh[b],
                    periodic_width=W))
                diff = np.abs(got[b, d].astype(np.float64) - ref)
                diff = np.minimum(diff, W - diff)
                assert np.all(diff <= np.spacing(np.float32(2 * W)))

    def test_decode_deterministic_across_mesh_sizes(self):
        """Decoded bits must not depend on how many devices decode them --
        the key derivation is per *global* block index."""
        x = make_blocks(B=8, nb=256)
        results = []
        for n_dev in (1, 2, 8):
            mesh = make_mesh(n_dev)
            codec = ShardedPositionCodec(mesh=mesh, width=W,
                                         depth=spmd_depth_for(1e-3, W))
            words, x0, rng_b = codec.encode(x)
            results.append(np.asarray(codec.decode(words, x0, rng_b,
                                                   seed=11)))
        np.testing.assert_array_equal(results[0], results[1])
        np.testing.assert_array_equal(results[0], results[2])


class TestBlockSplit:
    def test_split_3d(self):
        x = np.arange(3 * 64, dtype=np.float32).reshape(3, 64)
        b = block_split(x, 4)
        assert b.shape == (4, 3, 16)
        np.testing.assert_array_equal(b[0], x[:, :16])

    def test_split_1d(self):
        x = np.arange(64, dtype=np.uint64)
        b = block_split(x, 8)
        assert b.shape == (8, 8)

    def test_indivisible_asserts(self):
        with pytest.raises(AssertionError):
            block_split(np.zeros((3, 10)), 3)


class TestShardedSnapshotCodec:
    def _make(self, B=16, nb=512, seed=0, grid=1024):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0, W, (B, 3, nb)).astype(np.float32)
        vel = rng.normal(0, 200, (B, 3, nb)).astype(np.float32)
        ids = rng.permutation(grid * grid * 4)[: B * nb].astype(
            np.uint64).reshape(B, nb)
        return pos, vel, ids

    def _codec(self, mesh, **kw):
        from minnow_c_tpu.parallel.sharding import ShardedSnapshotCodec
        from minnow_c_tpu.quant.engine import delta_to_depth
        return ShardedSnapshotCodec(
            mesh=mesh, box=W, pos_depth=spmd_depth_for(1e-3, W),
            vel_depth=delta_to_depth(1.0, -2000.0, 2000.0),
            id_grid=1024, **kw)

    def test_full_snapshot_roundtrip(self):
        mesh = make_mesh(8)
        codec = self._codec(mesh)
        pos, vel, ids = self._make()
        enc = codec.encode(pos, vel, ids)
        dpos, dvel, dids = codec.decode(enc, seed=5)
        perr = np.abs(np.asarray(dpos).reshape(pos.shape) - pos)
        perr = np.minimum(perr, W - perr)
        assert perr.max() <= 1e-3
        assert np.abs(np.asarray(dvel).reshape(vel.shape) -
                      vel).max() <= 1.0
        np.testing.assert_array_equal(np.asarray(dids), ids)

    def test_pos_stream_matches_position_codec(self):
        """Snapshot-codec position bits == ShardedPositionCodec bits at
        the same seed (shared per-(block, dim) dither streams)."""
        mesh = make_mesh(4)
        codec = self._codec(mesh)
        pos, vel, ids = self._make(B=8, nb=256, seed=3)
        enc = codec.encode(pos, vel, ids)
        dpos, _, _ = codec.decode(enc, seed=9)

        pcodec = ShardedPositionCodec(mesh=mesh, width=W,
                                      depth=spmd_depth_for(1e-3, W))
        words, x0, rng_b = pcodec.encode(pos)
        np.testing.assert_array_equal(np.asarray(enc[0]), np.asarray(words))
        ref = pcodec.decode(words, x0, rng_b, seed=9)
        np.testing.assert_array_equal(np.asarray(dpos), np.asarray(ref))

    def test_vel_streams_distinct_from_pos(self):
        """Velocity dither keys must not collide with position keys: feed
        identical data to both fields and require different dither."""
        mesh = make_mesh(2)
        codec = self._codec(mesh)
        pos, _, ids = self._make(B=4, nb=256, seed=4)
        posv = np.clip(pos, 1.0, W - 1.0)  # same array for both fields
        enc = codec.encode(posv, posv, ids)
        dpos, dvel, _ = codec.decode(enc, seed=2)
        assert not np.array_equal(np.asarray(dpos), np.asarray(dvel))

    def test_streams_match_single_device_mesh(self):
        """Every encode output on an 8-device mesh == on one device."""
        pos, vel, ids = self._make(B=8, nb=512, seed=6)
        a = self._codec(make_mesh(8)).encode(pos, vel, ids)
        b = self._codec(make_mesh(1)).encode(pos, vel, ids)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_decode_deterministic_across_mesh_sizes(self):
        pos, vel, ids = self._make(B=8, nb=256, seed=8)
        outs = []
        for n_dev in (1, 4):
            codec = self._codec(make_mesh(n_dev))
            enc = codec.encode(pos, vel, ids)
            outs.append([np.asarray(a) for a in codec.decode(enc, seed=1)])
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)

    def test_misaligned_block_size_rejected(self):
        """Non-32-aligned blocks would decode to a wrong-length block
        (n_b is re-derived from padded word counts); encode must refuse
        them loudly."""
        codec = self._codec(make_mesh(2))
        pos, vel, ids = self._make(B=4, nb=256, seed=1)
        with pytest.raises(ValueError, match="multiple of 32"):
            codec.encode(pos[:, :, :100], vel[:, :, :100], ids[:, :100])
        pcodec = ShardedPositionCodec(mesh=make_mesh(2), width=W,
                                      depth=spmd_depth_for(1e-3, W))
        with pytest.raises(ValueError, match="multiple of 32"):
            pcodec.encode(pos[:, :, :100])

    def test_degenerate_depths_rejected(self):
        from minnow_c_tpu.parallel.sharding import ShardedSnapshotCodec
        with pytest.raises(ValueError, match="depths"):
            ShardedSnapshotCodec(mesh=make_mesh(2), box=W, pos_depth=0,
                                 vel_depth=10, id_grid=1024)
        with pytest.raises(ValueError, match="id_grid"):
            ShardedSnapshotCodec(mesh=make_mesh(2), box=W, pos_depth=16,
                                 vel_depth=10, id_grid=1)
