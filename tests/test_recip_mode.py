"""The 'recip' scale mode: reciprocal-multiply bin map
(kernels.uniform_bin_index_recip) vs the default C-exact division map.

Contracts verified here:
  * the device map == the numpy recip map, single-stream and rows --
    the cross-backend bit-identity that makes the map freezable;
  * the encoder-side map swap is wire-compatible: recip streams decode
    through the unchanged decoders within the requested deltas;
  * engine / segment API / batched snapshot writer / sharded SPMD codec
    all honor the flag and stay deterministic;
  * off-by-at-most-one-bin vs the division map (the documented error
    class).
"""

import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import minnow_c_tpu as mnw
from minnow_c_tpu.algos import registry
from minnow_c_tpu.ops import fastpath, kernels, native
from minnow_c_tpu.parallel import snapshot
from minnow_c_tpu.parallel.sharding import (
    ShardedPositionCodec,
    ShardedSnapshotCodec,
    make_mesh,
    spmd_depth_for,
)
from minnow_c_tpu.segment import api

W = 64.0


def _pos_field(pos, n, delta=1e-3):
    ver = registry.newest(mnw.AlgoCode.TRIM)
    return mnw.Field(
        hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.TRIM, ver, n),
        data=pos, acc=mnw.PositionAccuracy(delta=delta, width=W))


class TestRecipMap:
    def test_map_off_by_at_most_one_bin(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(3.0, 9.0, 100_000).astype(np.float32))
        for depth in (1, 7, 14, 24):
            a = kernels.uniform_bin_index(x, depth, 3.0, 6.0)
            b = kernels.uniform_bin_index_recip(x, depth, 3.0, 6.0)
            d = np.abs(np.asarray(a).astype(np.int64) -
                       np.asarray(b).astype(np.int64))
            assert d.max() <= 1, f"depth {depth}: bins differ by {d.max()}"

    def test_constant_plane_pins_bin_zero(self):
        x = jnp.full((64,), 5.0, jnp.float32)
        b = kernels.uniform_bin_index_recip(x, 8, 5.0, 0.0)
        assert (np.asarray(b) == 0).all()

    def test_monotone(self):
        x = jnp.asarray(np.linspace(0, 6, 50_000, dtype=np.float32))
        b = np.asarray(kernels.uniform_bin_index_recip(x, 12, 0.0, 6.0))
        assert (np.diff(b.astype(np.int64)) >= 0).all()


def _recip_bins_np(x, x0, recip, box, width):
    """The recip map in numpy: anchored unwrap, then
    trunc(clamp(((x - x0) * recip) * 2^width)), one rounding per op."""
    if box is not None:
        half = np.float32(box) * np.float32(0.5)
        a = x[0]
        x = np.where(x - a >= half, x - np.float32(box), x)
        x = np.where(x - a < -half, x + np.float32(box), x)
    nb = np.float32(1 << width)
    scaled = ((x - np.float32(x0)) * np.float32(recip)) * nb
    si = np.where(scaled < 0, 0, np.where(scaled >= nb, (1 << width) - 1,
                                          scaled.astype(np.int64)))
    return si.astype(np.uint32)


class TestRecipNumpyParity:
    """The device recip encodes vs the numpy recip map, bit for bit."""

    def test_single_stream(self):
        rng = np.random.default_rng(1)
        n = (1 << 14) * 3 + 160  # not a multiple of 32
        xh = rng.uniform(0, W, n).astype(np.float32)
        for periodic in (True, False):
            box = W if periodic else None
            wx, x0x, rx = fastpath.fast_uniform_encode(
                jnp.asarray(xh), 14, periodic_width=box, scale_mode="recip")
            if periodic:
                a = xh[0]
                L = np.float32(W)
                xu = np.where(xh - a >= L / 2, xh - L, xh)
                xu = np.where(xu - a < -L / 2, xu + L, xu).astype(np.float32)
            else:
                xu = xh
            lo, hi = xu.min(), xu.max()
            assert float(x0x) == float(lo) and float(rx) == float(hi - lo)
            bins = _recip_bins_np(xh, lo, np.float32(1) / (hi - lo), box, 14)
            assert np.array_equal(np.asarray(wx),
                                  native.uniform_pack_host(bins, 14))

    def test_rows_kernel(self):
        from minnow_c_tpu.parallel.sharding import _rows_encode_recip_raw
        rng = np.random.default_rng(2)
        rows, n = 6, 4096 + 32  # 32-aligned
        x = rng.uniform(0, W, (rows, n)).astype(np.float32)
        x0 = rng.uniform(0, 4, rows).astype(np.float32)
        rngv = rng.uniform(40, 60, rows).astype(np.float32)
        wk = np.asarray(_rows_encode_recip_raw(
            jnp.asarray(x), jnp.asarray(x0), jnp.asarray(rngv), 11, W))
        for r in range(rows):
            bins = _recip_bins_np(x[r], x0[r], np.float32(1) / rngv[r], W,
                                  11)
            assert np.array_equal(wk[r], native.uniform_pack_host(bins, 11)), r


class TestSegmentAPI:
    def test_roundtrip_within_delta_and_deterministic(self):
        rng = np.random.default_rng(3)
        n = 60_000
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)
        f = _pos_field(pos, n)
        blob = api.compress_segment(mnw.Seg(fields=[f]), seed=9,
                                    scale_mode="recip")
        blob2 = api.compress_segment(mnw.Seg(fields=[f]), seed=9,
                                     scale_mode="recip")
        assert blob == blob2  # deterministic encode
        out = api.decompress_segment(blob).fields[0]
        err = np.abs(np.asarray(out.data) - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_recip_stream_decodes_via_both_paths(self):
        rng = np.random.default_rng(4)
        n = 50_016
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)
        blob = api.compress_segment(mnw.Seg(fields=[_pos_field(pos, n)]),
                                    seed=2, scale_mode="recip")
        a = api.decompress_segment(blob, fused=False).fields[0]
        b = api.decompress_segment(blob, fused=True).fields[0]
        assert np.array_equal(np.asarray(a.data), np.asarray(b.data))

    def test_bad_mode_raises(self):
        with pytest.raises(ValueError, match="scale_mode"):
            api.compress_segment(mnw.Seg(fields=[]), scale_mode="exp")

    def test_compressed_size_matches_div_mode(self):
        """The recip map changes at most boundary bins (values, not
        counts or widths): packed plane sizes are identical by
        construction, and the LZ4 stage sees near-identical bytes -- so
        the 'compressed size <= C reference' target carries over.
        Allow a tiny LZ4 wiggle."""
        rng = np.random.default_rng(12)
        n = 40_000
        steps = rng.normal(0, 0.01, (3, n)).astype(np.float32)
        pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
        f = _pos_field(pos, n)
        a = len(api.compress_segment(mnw.Seg(fields=[f]), seed=1,
                                     scale_mode="div"))
        b = len(api.compress_segment(mnw.Seg(fields=[f]), seed=1,
                                     scale_mode="recip"))
        assert abs(a - b) <= max(64, a // 1000), (a, b)


class TestSnapshotWriter:
    @pytest.mark.parametrize("nb_total,blocks", [(4096 * 4, 4),
                                                 (1234 * 2, 2)])
    def test_snapshot_roundtrip(self, nb_total, blocks):
        rng = np.random.default_rng(5)
        pos = rng.uniform(0, W, (3, nb_total)).astype(np.float32)
        vel = rng.normal(0, 200, (3, nb_total)).astype(np.float32)
        ids = rng.permutation(1 << 16)[:nb_total].astype(np.uint64)
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=W),
            vel=mnw.VelocityAccuracy(delta=1.0),
            ids=mnw.IDAccuracy(width=1024))
        buf = io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                   num_blocks=blocks, seed=3,
                                   scale_mode="recip")
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        ep = np.abs(out["pos"] - pos)
        ep = np.minimum(ep, W - ep)
        assert ep.max() <= 1e-3
        assert np.abs(out["vel"] - vel).max() <= 1.0
        assert (out["ids"] == ids).all()

    def test_symlog_velocity(self):
        rng = np.random.default_rng(6)
        n = 4096
        vel = (rng.normal(0, 1, (3, n)) ** 3 * 500).astype(np.float32)
        spec = snapshot.SnapshotSpec(
            vel=mnw.VelocityAccuracy(delta=0.05, sym_log10_scaled=1,
                                     sym_log10_threshold=1.0))
        buf = io.BytesIO()
        snapshot.compress_snapshot(buf, None, vel, None, spec,
                                   num_blocks=2, seed=1,
                                   scale_mode="recip")
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        # symlog delta applies in mapped space; invert the bound:
        # |ymap - ymap'| <= delta
        t = 1.0
        ym = np.sign(vel) * np.log10(1 + np.abs(vel) / t)
        ym2 = np.sign(out["vel"]) * np.log10(1 + np.abs(out["vel"]) / t)
        assert np.abs(ym - ym2).max() <= 0.05 * 1.01

    def test_streaming_matches_one_pass_mode(self):
        rng = np.random.default_rng(7)
        nb = 2048
        pos = rng.uniform(0, W, (3, nb * 2)).astype(np.float32)
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=W))
        one = io.BytesIO()
        snapshot.compress_snapshot(one, pos, None, None, spec,
                                   num_blocks=2, seed=4,
                                   scale_mode="recip")
        stream = io.BytesIO()
        snapshot.compress_snapshot_streaming(
            stream, ({"pos": pos[:, i * nb:(i + 1) * nb]}
                     for i in range(2)),
            spec, seed=4, scale_mode="recip")
        s1 = one.getvalue()
        s2 = stream.getvalue()
        # streaming writes per-block ranges (self-describing segments);
        # both must decode identically within delta and be valid files
        one.seek(0)
        stream.seek(0)
        a = snapshot.decompress_snapshot(one)["pos"]
        b = snapshot.decompress_snapshot(stream)["pos"]
        for arr in (a, b):
            e = np.abs(arr - pos)
            e = np.minimum(e, W - e)
            assert e.max() <= 1e-3
        assert len(s1) > 0 and len(s2) > 0


class TestDrivers:
    def test_gadget2_recip_roundtrip(self, tmp_path):
        from minnow_c_tpu.drivers import gadget2
        rng = np.random.default_rng(11)
        n = 3000
        hdr = gadget2.Gadget2Header(
            npart=(0, n, 0, 0, 0, 0), mass=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
            time=0.5, redshift=1.5, box_size=W, omega0=0.3,
            omega_lambda=0.7, hubble_param=0.7)
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)
        vel = rng.normal(0, 100, (3, n)).astype(np.float32)
        ids = rng.permutation(n).astype(np.uint64)
        raw = tmp_path / "snap.g2"
        with open(raw, "wb") as f:
            gadget2.write_snapshot(f, hdr, pos, vel, ids)
        out = tmp_path / "snap.g2.min"
        with open(raw, "rb") as fi, open(out, "wb") as fo:
            gadget2.compress(fi, fo, pos_delta=1e-3, vel_delta=1.0,
                             scale_mode="recip")
        back = tmp_path / "back.g2"
        with open(out, "rb") as fi, open(back, "wb") as fo:
            gadget2.decompress(fi, fo)
        with open(back, "rb") as f:
            hdr2, p2, v2, i2 = gadget2.read_snapshot(f)
        e = np.abs(np.asarray(p2) - pos)
        e = np.minimum(e, W - e)
        assert e.max() <= 1e-3
        assert np.abs(np.asarray(v2) - vel).max() <= 1.0
        assert np.array_equal(i2, ids)


class TestShardedCodecs:
    def test_position_codec_recip_roundtrip(self):
        mesh = make_mesh(8)
        depth = spmd_depth_for(1e-3, W)
        codec = ShardedPositionCodec(mesh=mesh, width=W, depth=depth,
                                     scale_mode="recip")
        rng = np.random.default_rng(8)
        x = rng.uniform(0, W, (16, 3, 512)).astype(np.float32)
        words, x0, rng_b = codec.encode(x)
        out = np.asarray(codec.decode(words, x0, rng_b,
                                      seed=5)).reshape(x.shape)
        err = np.abs(out - x)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_position_codec_recip_mesh_independent_bits(self):
        """Recip encode on a 4-device mesh == on one device, bit for
        bit."""
        depth = spmd_depth_for(1e-3, W)
        rng = np.random.default_rng(9)
        x = rng.uniform(0, W, (8, 3, 256)).astype(np.float32)
        a = ShardedPositionCodec(mesh=make_mesh(4), width=W, depth=depth,
                                 scale_mode="recip")
        b = ShardedPositionCodec(mesh=make_mesh(1), width=W, depth=depth,
                                 scale_mode="recip")
        wa = a.encode(x)
        wb = b.encode(x)
        assert np.array_equal(np.asarray(wa[0]), np.asarray(wb[0]))
        assert np.array_equal(np.asarray(wa[1]), np.asarray(wb[1]))

    def test_snapshot_codec_recip(self):
        mesh = make_mesh(8)
        depth = spmd_depth_for(1e-3, W)
        snapc = ShardedSnapshotCodec(
            mesh=mesh, box=W, pos_depth=depth,
            vel_depth=spmd_depth_for(1.0, 4000.0), id_grid=1024,
            scale_mode="recip")
        rng = np.random.default_rng(10)
        B, nb = 16, 256
        pos = rng.uniform(0, W, (B, 3, nb)).astype(np.float32)
        vel = rng.normal(0, 200, (B, 3, nb)).astype(np.float32)
        ids = rng.permutation(1 << 20)[: B * nb].astype(
            np.uint64).reshape(B, nb)
        enc = snapc.encode(pos, vel, ids)
        dpos, dvel, dids = snapc.decode(enc, seed=7)
        err = np.abs(np.asarray(dpos).reshape(pos.shape) - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3
        assert np.abs(np.asarray(dvel).reshape(vel.shape) -
                      vel).max() <= 1.0
        assert np.array_equal(np.asarray(dids), ids)

    def test_bad_mode_raises(self):
        mesh = make_mesh(2)
        with pytest.raises(ValueError, match="scale_mode"):
            ShardedPositionCodec(mesh=mesh, width=W, depth=10,
                                 scale_mode="x")
