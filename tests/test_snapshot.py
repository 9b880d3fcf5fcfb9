"""Snapshot-scale parallel pipeline tests: batched block encode produces
standard segments; ordered gather reconstructs; interop with the scalar
path holds both directions."""

import io as _io

import numpy as np

import minnow_c_tpu as mnw
from minnow_c_tpu.parallel import snapshot
from minnow_c_tpu.segment import api, io as seg_io


def make_snapshot(n=64 * 1024, W=64.0, seed=0):
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.02, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1024 ** 2 * 16)[:n].astype(np.uint64)
    return pos, vel, ids


SPEC = snapshot.SnapshotSpec(
    pos=mnw.PositionAccuracy(delta=1e-3, width=64.0),
    vel=mnw.VelocityAccuracy(delta=1.0),
    ids=mnw.IDAccuracy(width=1024),
)


class TestSnapshotRoundTrip:
    def test_blocks_roundtrip(self):
        pos, vel, ids = make_snapshot()
        buf = _io.BytesIO()
        stats = snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                           num_blocks=8, seed=3)
        raw = pos.nbytes + vel.nbytes + ids.nbytes
        assert stats["bytes"] < raw
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        err = np.abs(out["pos"] - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3
        assert np.abs(out["vel"] - vel).max() <= 1.0
        np.testing.assert_array_equal(out["ids"], ids)

    def test_batched_symlog_velocities_match_fallback(self):
        """symlog-scaled velocities decode through the batched device
        pass (no silent fallback), bit-identical to the per-segment
        path."""
        pos, vel, ids = make_snapshot(n=16384)
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=64.0),
            vel=mnw.VelocityAccuracy(delta=0.01, sym_log10_scaled=2,
                                     sym_log10_threshold=20.0),
            ids=mnw.IDAccuracy(width=1024))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec, num_blocks=4,
                                   seed=7)
        buf.seek(0)
        out_b = snapshot.decompress_snapshot(buf, batched=True)
        buf.seek(0)
        out_g = snapshot.decompress_snapshot(buf, batched=False)
        np.testing.assert_array_equal(out_b["vel"], out_g["vel"])
        np.testing.assert_array_equal(out_b["pos"], out_g["pos"])

    def test_block_count_preserved_in_order(self):
        pos, vel, ids = make_snapshot(n=4096)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, None, ids, SPEC, num_blocks=4)
        buf.seek(0)
        hds = list(seg_io.iter_headers(buf))
        assert len(hds) == 4
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        # ordered gather: ids come back in exact original order
        np.testing.assert_array_equal(out["ids"], ids)

    def test_single_block_equivalent(self):
        pos, vel, ids = make_snapshot(n=2048)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=1)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        err = np.abs(out["pos"] - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3
        np.testing.assert_array_equal(out["ids"], ids)

    def test_indivisible_raises(self):
        pos, vel, ids = make_snapshot(n=1000)
        buf = _io.BytesIO()
        try:
            snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                       num_blocks=7)
            assert False, "expected ValueError"
        except ValueError:
            pass


class TestScalarInterop:
    def test_scalar_decoder_reads_parallel_segments(self):
        """Each parallel-written segment is a standard wire segment the
        scalar API can decode alone."""
        pos, vel, ids = make_snapshot(n=8192)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=4,
                                   seed=9)
        buf.seek(0)
        segs = [s for _, s in seg_io.iter_segments(buf)]
        assert len(segs) == 4
        nb = 8192 // 4
        seg0 = api.decompress_segment(segs[0])
        codes = [f.hd.field_code for f in seg0.fields]
        assert set(codes) == {int(mnw.FieldCode.POSN),
                              int(mnw.FieldCode.VELC),
                              int(mnw.FieldCode.PTID)}
        for f in seg0.fields:
            if f.hd.field_code == mnw.FieldCode.PTID:
                np.testing.assert_array_equal(np.asarray(f.data), ids[:nb])
            if f.hd.field_code == mnw.FieldCode.POSN:
                err = np.abs(np.asarray(f.data) - pos[:, :nb])
                err = np.minimum(err, 64.0 - err)
                assert err.max() <= 1e-3

    def test_id_grid_wrap_blocks(self):
        """IDs clustered across the grid boundary survive the per-block
        origin bookkeeping (global offset + block min)."""
        W = 100
        n = 2048
        rng = np.random.default_rng(5)
        xs = (rng.integers(95, 105, n) % W).astype(np.uint64)
        ys = rng.integers(40, 60, n).astype(np.uint64)
        zs = (rng.integers(98, 102, n) % W).astype(np.uint64)
        ids = xs + W * ys + W * W * zs
        spec = snapshot.SnapshotSpec(ids=mnw.IDAccuracy(width=W))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, None, None, ids, spec, num_blocks=4)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        np.testing.assert_array_equal(out["ids"], ids)


class TestOddShapes:
    def test_block_size_not_multiple_of_32(self):
        # nb = 1000 with odd ID widths exercises per-block pack padding
        n = 4000
        rng = np.random.default_rng(8)
        ids = rng.integers(0, 100**3, n, dtype=np.uint64)  # width ~20ish
        pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=64.0),
            ids=mnw.IDAccuracy(width=100))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, None, ids, spec, num_blocks=4)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        np.testing.assert_array_equal(out["ids"], ids)
        err = np.abs(out["pos"] - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3


class TestSymlogVelocity:
    def test_symlog_velocity_snapshot(self):
        n = 4096
        rng = np.random.default_rng(12)
        vel = rng.normal(0, 300, (3, n)).astype(np.float32)
        spec = snapshot.SnapshotSpec(
            vel=mnw.VelocityAccuracy(delta=1e-3, sym_log10_scaled=2,
                                     sym_log10_threshold=1.0))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, None, vel, None, spec, num_blocks=4,
                                   seed=3)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        sl = lambda x: np.sign(x) * np.log10(1 + np.abs(x))
        err = np.abs(sl(out["vel"]) - sl(vel))
        assert err.max() <= 1.2e-3  # delta bound in symlog space


class TestBatchedDecode:
    def test_batched_bit_identical_to_fallback(self):
        pos, vel, ids = make_snapshot(n=16384)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=4,
                                   seed=7)
        buf.seek(0)
        a = snapshot.decompress_snapshot(buf, batched=True)
        buf.seek(0)
        b = snapshot.decompress_snapshot(buf, batched=False)
        for k in ("pos", "vel", "ids"):
            np.testing.assert_array_equal(a[k], b[k])

    def test_batched_rows_kernel_bit_identical(self):
        """The batched reader (one program per field dim over all blocks)
        must produce the same bits as the per-segment fallback, with the
        blocks' shared-key dither restarting at counter 0 per block."""
        pos, vel, ids = make_snapshot(n=16384, seed=13)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=8,
                                   seed=9)
        buf.seek(0)
        ref = snapshot.decompress_snapshot(buf, batched=False)
        buf.seek(0)
        got = snapshot.decompress_snapshot(buf, batched=True)
        for k in ("pos", "vel", "ids"):
            np.testing.assert_array_equal(got[k], ref[k])

    def test_batched_falls_back_on_symlog(self):
        n = 2048
        rng = np.random.default_rng(3)
        vel = rng.normal(0, 300, (3, n)).astype(np.float32)
        spec = snapshot.SnapshotSpec(
            vel=mnw.VelocityAccuracy(delta=1e-3, sym_log10_scaled=2,
                                     sym_log10_threshold=1.0))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, None, vel, None, spec, num_blocks=2)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf, batched=True)  # falls back
        sl = lambda x: np.sign(x) * np.log10(1 + np.abs(x))
        assert np.abs(sl(out["vel"]) - sl(vel)).max() <= 1.2e-3


def test_snapshot_field_filter():
    """decompress_snapshot(fields=...) returns only the requested
    fields, bit-identical to a full read, on both the batched and the
    per-segment paths."""
    pos, vel, ids = make_snapshot(n=16384)
    buf = _io.BytesIO()
    snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=4,
                               seed=3)
    buf.seek(0)
    full = snapshot.decompress_snapshot(buf)
    for batched in (True, False):
        buf.seek(0)
        got = snapshot.decompress_snapshot(buf, batched=batched,
                                           fields={"pos"})
        assert set(got) == {"pos"}
        np.testing.assert_array_equal(np.asarray(got["pos"]),
                                      np.asarray(full["pos"]))


def test_snapshot_field_filter_selectors():
    """FieldCode selectors work (matching decompress_segment), and an
    unknown name raises ValueError naming the valid keys — not a bare
    KeyError before the file is read."""
    import pytest
    pos, vel, ids = make_snapshot(n=4096)
    buf = _io.BytesIO()
    snapshot.compress_snapshot(buf, pos, vel, ids, SPEC, num_blocks=2,
                               seed=3)
    buf.seek(0)
    full = snapshot.decompress_snapshot(buf)
    buf.seek(0)
    got = snapshot.decompress_snapshot(buf, fields={mnw.FieldCode.VELC})
    assert set(got) == {"vel"}
    np.testing.assert_array_equal(np.asarray(got["vel"]),
                                  np.asarray(full["vel"]))
    buf.seek(0)
    with pytest.raises(ValueError, match="pos"):
        snapshot.decompress_snapshot(buf, fields={"positions"})


class TestMassField:
    """Scalar per-particle float fields (UNSF) through the snapshot
    writer -- the Gadget-2 MASS client duty
    (header_format.tex:44-68)."""

    def _spec(self, mass_acc):
        return snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=64.0),
            vel=mnw.VelocityAccuracy(delta=1.0),
            ids=mnw.IDAccuracy(width=1024),
            mass=mass_acc)

    def test_mass_roundtrip_linear(self):
        pos, vel, ids = make_snapshot(n=16384)
        rng = np.random.default_rng(5)
        mass = rng.uniform(0.5, 3.0, 16384).astype(np.float32)
        spec = self._spec(mnw.FloatAccuracy(delta=1e-4))
        buf = _io.BytesIO()
        stats = snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                           num_blocks=4, seed=3,
                                           mass=mass)
        assert "mass_depth" in stats
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        assert out["mass"].shape == (16384,)
        assert np.abs(out["mass"] - mass).max() <= 1e-4

    def test_mass_batched_matches_per_segment(self):
        """Batched UNSF decode is bit-identical to the per-segment
        path."""
        pos, vel, ids = make_snapshot(n=8192)
        rng = np.random.default_rng(6)
        mass = rng.uniform(0.1, 10.0, 8192).astype(np.float32)
        spec = self._spec(mnw.FloatAccuracy(delta=1e-4))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                   num_blocks=4, seed=9, mass=mass)
        buf.seek(0)
        out_b = snapshot.decompress_snapshot(buf, batched=True)
        buf.seek(0)
        out_s = snapshot.decompress_snapshot(buf, batched=False)
        np.testing.assert_array_equal(out_b["mass"], out_s["mass"])

    def test_mass_log10_relative(self):
        """log10-mapped masses give relative accuracy across orders of
        magnitude."""
        n = 8192
        pos, vel, ids = make_snapshot(n=n)
        rng = np.random.default_rng(7)
        mass = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
        rel = 1e-4
        spec = self._spec(mnw.FloatAccuracy(
            delta=float(np.log10(1.0 + rel)), log10_scaled=1))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                   num_blocks=2, seed=1, mass=mass)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        rel_err = np.abs(out["mass"] - mass) / mass
        assert rel_err.max() <= 1.5 * rel

    def test_mass_recip_mode(self):
        pos, vel, ids = make_snapshot(n=4096)
        rng = np.random.default_rng(8)
        mass = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
        spec = self._spec(mnw.FloatAccuracy(delta=1e-4))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                   num_blocks=2, seed=4, mass=mass,
                                   scale_mode="recip")
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        assert np.abs(out["mass"] - mass).max() <= 1e-4

    def test_mass_selective_decode(self):
        pos, vel, ids = make_snapshot(n=4096)
        mass = np.linspace(1.0, 2.0, 4096).astype(np.float32)
        spec = self._spec(mnw.FloatAccuracy(delta=1e-4))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                   num_blocks=2, seed=2, mass=mass)
        buf.seek(0)
        got = snapshot.decompress_snapshot(buf, fields={"mass"})
        assert set(got) == {"mass"}
        assert np.abs(got["mass"] - mass).max() <= 1e-4

    def test_mass_streaming_writer(self):
        rng = np.random.default_rng(11)
        waves = []
        for _ in range(3):
            p, v, i = make_snapshot(n=2048, seed=int(rng.integers(1e6)))
            m = rng.uniform(0.5, 2.0, 2048).astype(np.float32)
            waves.append({"pos": p, "vel": v, "ids": i, "mass": m})
        spec = self._spec(mnw.FloatAccuracy(delta=1e-4))
        buf = _io.BytesIO()
        snapshot.compress_snapshot_streaming(buf, iter(waves), spec,
                                             seed=5)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        mass_all = np.concatenate([w["mass"] for w in waves])
        assert np.abs(out["mass"] - mass_all).max() <= 1e-4

    def test_mass_without_spec_raises(self):
        pos, vel, ids = make_snapshot(n=1024)
        mass = np.ones(1024, np.float32)
        buf = _io.BytesIO()
        import pytest
        with pytest.raises(ValueError, match="spec.mass"):
            snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                       num_blocks=1, mass=mass)


def test_multihost_writer_single_process_byte_parity(tmp_path):
    """compress_snapshot_multihost degenerates to the single-host writer
    bit-for-bit when process_count == 1 (same depths, same streams, same
    chained file bytes)."""
    pos, vel, ids = make_snapshot(n=8192)
    f1 = tmp_path / "single.min"
    with open(f1, "wb") as f:
        snapshot.compress_snapshot(f, pos, vel, ids, SPEC, num_blocks=4,
                                   seed=3)
    f2 = tmp_path / "multi.min"
    with open(f2, "wb") as f:
        st = snapshot.compress_snapshot_multihost(
            f, pos, vel, ids, SPEC, num_blocks_local=4, seed=3)
    assert f1.read_bytes() == f2.read_bytes()
    assert st["num_blocks"] == 4
    with open(f2, "rb") as f:
        out = snapshot.decompress_snapshot(f)
    np.testing.assert_array_equal(out["ids"], ids)


class TestMultihostRead:
    """decompress_snapshot_multihost in its single-process degenerate
    form (P=1): whole-file read, global arrays sharded over the virtual
    8-device mesh.  The genuine two-process skip-ahead leg lives in
    tests/test_multihost.py."""

    def test_single_process_read_matches(self):
        import jax
        from jax.sharding import Mesh
        pos, vel, ids = make_snapshot(n=8 * 4096)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                   num_blocks=8, seed=3)
        buf.seek(0)
        full = snapshot.decompress_snapshot(buf)
        buf.seek(0)
        mesh = Mesh(np.asarray(jax.devices()), ("blocks",))
        got = snapshot.decompress_snapshot_multihost(buf, mesh=mesh)
        assert got["num_blocks"] == 8 and got["blocks_local"] == 8
        assert got["n_per_block"] == 4096
        np.testing.assert_array_equal(got["local"]["pos"], full["pos"])
        np.testing.assert_array_equal(got["local"]["ids"], full["ids"])
        # the global sharded array reassembles to the same values
        gp = np.asarray(got["pos"])            # (8, 3, 4096)
        np.testing.assert_array_equal(
            np.concatenate([gp[b] for b in range(8)], axis=1),
            full["pos"])
        gi = np.asarray(got["ids"]).reshape(-1)
        np.testing.assert_array_equal(gi, full["ids"])

    def test_field_selection(self):
        pos, vel, ids = make_snapshot(n=4 * 2048)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                   num_blocks=4, seed=3)
        buf.seek(0)
        got = snapshot.decompress_snapshot_multihost(buf, fields=["ids"])
        assert "pos" not in got["local"] and "ids" in got["local"]
        buf.seek(0)
        full = snapshot.decompress_snapshot(buf)
        np.testing.assert_array_equal(got["local"]["ids"], full["ids"])

    def test_indivisible_raises(self):
        import unittest.mock as mock
        import jax
        pos, vel, ids = make_snapshot(n=3 * 2048)
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, pos, vel, ids, SPEC,
                                   num_blocks=3, seed=3)
        buf.seek(0)
        with mock.patch.object(jax, "process_count", return_value=2):
            import pytest
            with pytest.raises(ValueError, match="divide across"):
                snapshot.decompress_snapshot_multihost(buf)


class TestSnapshotDeltas:
    """Per-particle accuracy (Deltas) at snapshot scale (round-5 item 5):
    compress_snapshot routes Deltas fields through Trim v1.1 per block;
    the reader (batched path falls back, per-segment fused path decodes)
    honors each particle's own delta."""

    def test_pos_deltas_roundtrip(self):
        n = 4 * 4096
        W = 64.0
        pos, vel, ids = make_snapshot(n=n)
        rng = np.random.default_rng(5)
        # mixed accuracy: most particles coarse, a clustered tenth fine
        deltas = np.full(n, 1e-2, np.float32)
        fine = rng.choice(n, n // 10, replace=False)
        deltas[fine] = 1e-4
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-2, deltas=deltas, width=W),
            ids=mnw.IDAccuracy(width=1024))
        buf = _io.BytesIO()
        st = snapshot.compress_snapshot(buf, pos, None, ids, spec,
                                        num_blocks=4, seed=3)
        assert st["pos_depth"] == "per-particle"
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        err = np.abs(out["pos"] - pos)
        err = np.minimum(err, W - err)
        assert (err <= deltas[None, :]).all(), float(err.max())
        # the fine subset really is finer than the coarse bound
        assert err[:, fine].max() <= 1e-4
        np.testing.assert_array_equal(out["ids"], ids)

    def test_vel_and_mass_deltas(self):
        n = 2 * 4096
        pos, vel, ids = make_snapshot(n=n)
        rng = np.random.default_rng(6)
        vdel = rng.uniform(0.5, 4.0, n).astype(np.float32)
        mass = (10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)
        mdel = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
        from minnow_c_tpu.types import FloatAccuracy
        spec = snapshot.SnapshotSpec(
            vel=mnw.VelocityAccuracy(delta=4.0, deltas=vdel),
            mass=FloatAccuracy(delta=1e-2, deltas=mdel))
        buf = _io.BytesIO()
        snapshot.compress_snapshot(buf, None, vel, None, spec,
                                   num_blocks=2, seed=3, mass=mass)
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        assert (np.abs(out["vel"] - vel) <= vdel[None, :]).all()
        assert (np.abs(out["mass"] - mass) <= mdel).all()

    def test_streaming_and_multihost_reject_deltas(self):
        import pytest
        n = 2048
        deltas = np.full(n, 1e-3, np.float32)
        spec = snapshot.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, deltas=deltas,
                                     width=64.0))
        with pytest.raises(ValueError, match="per-particle deltas"):
            snapshot.compress_snapshot_streaming(_io.BytesIO(), iter([]),
                                                 spec)
        with pytest.raises(ValueError, match="per-particle deltas"):
            snapshot.compress_snapshot_multihost(
                _io.BytesIO(), np.zeros((3, n), np.float32), None, None,
                spec, num_blocks_local=1)
