"""Algorithm-level tests: every registered codec must round-trip every
field type; Diff must beat Trim on coherent data; corrupt blocks must
localize."""

import numpy as np
import pytest

import minnow_c_tpu as mnw
from minnow_c_tpu import semver
from minnow_c_tpu.algos import registry
from minnow_c_tpu.segment import api


ALGOS = [mnw.AlgoCode.TRIM, mnw.AlgoCode.DIFF, mnw.AlgoCode.COIL,
         mnw.AlgoCode.OCTO, mnw.AlgoCode.SORT, mnw.AlgoCode.CART]


def seg_with(algo, n=8000, seed=0, W=64.0, sorted_pos=False):
    rng = np.random.default_rng(seed)
    ver = registry.newest(algo)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    if sorted_pos:
        pos = pos[:, np.argsort(pos[0])]
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 22)[:n].astype(np.uint64)
    uf = rng.uniform(1, 2, n).astype(np.float32)
    ui = rng.integers(10**6, 10**6 + 5000, n).astype(np.uint64)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    seg = mnw.Seg(fields=[
        mnw.Field(hd=hd(mnw.FieldCode.POSN), data=pos,
                  acc=mnw.PositionAccuracy(delta=1e-3, width=W)),
        mnw.Field(hd=hd(mnw.FieldCode.VELC), data=vel,
                  acc=mnw.VelocityAccuracy(delta=0.5)),
        mnw.Field(hd=hd(mnw.FieldCode.PTID), data=ids,
                  acc=mnw.IDAccuracy(width=1024)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSF), data=uf,
                  acc=mnw.FloatAccuracy(delta=1e-4)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSI), data=ui,
                  acc=mnw.IntAccuracy()),
    ])
    return seg, pos, vel, ids, uf, ui


@pytest.mark.parametrize("algo", ALGOS)
class TestAllFieldTypes:
    def test_roundtrip(self, algo):
        W = 64.0
        seg, pos, vel, ids, uf, ui = seg_with(algo)
        blob = api.compress_segment(seg, seed=5)
        out = api.decompress_segment(blob)
        p2 = np.asarray(out.fields[0].data)
        err = np.abs(p2 - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3
        assert np.abs(np.asarray(out.fields[1].data) - vel).max() <= 0.5
        np.testing.assert_array_equal(np.asarray(out.fields[2].data), ids)
        assert np.abs(np.asarray(out.fields[3].data) - uf).max() <= 1e-4
        np.testing.assert_array_equal(np.asarray(out.fields[4].data), ui)

    def test_deterministic(self, algo):
        seg, *_ = seg_with(algo, n=2000)
        blob = api.compress_segment(seg, seed=9)
        a = api.decompress_segment(blob)
        b = api.decompress_segment(blob)
        for fa, fb in zip(a.fields, b.fields):
            np.testing.assert_array_equal(np.asarray(fa.data),
                                          np.asarray(fb.data))


class TestDiffCompression:
    def test_diff_beats_trim_on_coherent_data(self):
        # Spatially coherent order: particles along a random walk (as in a
        # cell-sorted snapshot) -- successive positions are close in all
        # three dims, so zigzag deltas pack far below the raw depth.
        n, W = 50000, 64.0
        rng = np.random.default_rng(7)
        steps = rng.normal(0, 0.02, (3, n)).astype(np.float32)
        pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W

        def one(algo):
            ver = registry.newest(algo)
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, ver, n),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            return api.compress_segment(seg, seed=1)

        blob_t = one(mnw.AlgoCode.TRIM)
        blob_d = one(mnw.AlgoCode.DIFF)
        assert len(blob_d) < 0.7 * len(blob_t)
        # and it still round-trips within delta
        out = api.decompress_segment(blob_d)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_diff_on_random_data_bounded_overhead(self):
        # Worst case: uncorrelated data costs Diff at most ~1 extra bit per
        # value vs Trim (zigzag sign bit).
        seg_t, *_ = seg_with(mnw.AlgoCode.TRIM, n=50000)
        seg_d, *_ = seg_with(mnw.AlgoCode.DIFF, n=50000)
        blob_t = api.compress_segment(seg_t, seed=1)
        blob_d = api.compress_segment(seg_d, seed=1)
        assert len(blob_d) <= len(blob_t) * 1.15

    def test_mixed_algos_in_one_segment(self):
        n, W = 3000, 32.0
        rng = np.random.default_rng(3)
        pos = np.sort(rng.uniform(0, W, (3, n)).astype(np.float32), axis=1)
        ids = rng.permutation(1 << 20)[:n].astype(np.uint64)
        seg = mnw.Seg(fields=[
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.POSN,
                                         mnw.AlgoCode.DIFF,
                                         registry.newest(mnw.AlgoCode.DIFF),
                                         n),
                      data=pos, acc=mnw.PositionAccuracy(delta=1e-3,
                                                         width=W)),
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.PTID,
                                         mnw.AlgoCode.TRIM,
                                         registry.newest(mnw.AlgoCode.TRIM),
                                         n),
                      data=ids, acc=mnw.IDAccuracy(width=1024)),
        ])
        blob = api.compress_segment(seg, seed=2)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3
        np.testing.assert_array_equal(np.asarray(out.fields[1].data), ids)


class TestCoilCompression:
    def _walk_with_jumps(self, n=60000, W=64.0, seed=11):
        # Mostly-smooth walk with occasional large jumps: chunked widths
        # (Coil) should beat one global width (Diff).
        rng = np.random.default_rng(seed)
        steps = rng.normal(0, 0.01, (3, n)).astype(np.float32)
        jumps = rng.random((3, n)) < 0.001
        steps = np.where(jumps, rng.uniform(-20, 20, (3, n)), steps)
        return (np.cumsum(steps, axis=1).astype(np.float32) + W / 2) % W

    def test_coil_beats_diff_on_jumpy_data(self):
        W = 64.0
        pos = self._walk_with_jumps()
        n = pos.shape[1]

        def one(algo):
            ver = registry.newest(algo)
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, ver, n),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            return api.compress_segment(seg, seed=1)

        blob_d = one(mnw.AlgoCode.DIFF)
        blob_c = one(mnw.AlgoCode.COIL)
        assert len(blob_c) < len(blob_d)
        out = api.decompress_segment(blob_c)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, W - err)
        assert err.max() <= 1e-3

    def test_coil_chunk_boundary_sizes(self):
        # n around the 256-element chunk boundary
        W = 8.0
        for n in (1, 255, 256, 257, 511, 513):
            rng = np.random.default_rng(n)
            pos = rng.uniform(0, W, (3, n)).astype(np.float32)
            ver = registry.newest(mnw.AlgoCode.COIL)
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.COIL,
                                   ver, n),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            out = api.decompress_segment(api.compress_segment(seg, seed=n))
            err = np.abs(np.asarray(out.fields[0].data) - pos)
            err = np.minimum(err, W - err)
            assert err.max() <= 1e-3, n


class TestRegistryVersioning:
    def test_both_registered(self):
        assert registry.supports(mnw.AlgoCode.TRIM, semver.pack(1, 0, 0))
        assert registry.supports(mnw.AlgoCode.DIFF, semver.pack(1, 0, 0))

    def test_codes_disjoint(self):
        assert int(mnw.AlgoCode.TRIM) != int(mnw.AlgoCode.DIFF)


class TestCompressedSizeParity:
    def test_trim_size_at_most_reference_pipeline(self):
        """BASELINE requirement: compressed size <= the reference's own
        pipeline at parity settings.  The reference's only realized
        encoder is its mock fast-uniform pipeline (bin at depth -> pack ->
        LZ4, test/compress_util_bench.c:234-298); compute that size with
        the same primitives and assert our Trim segment stays within a
        small fixed header overhead of it."""
        import jax.numpy as jnp

        from minnow_c_tpu.ops import bitpack, entropy, kernels
        from minnow_c_tpu.quant import engine as qe

        n, W, delta = 200_000, 64.0, 1e-3
        rng = np.random.default_rng(0)
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)

        # reference-equivalent size: per dim, bin at the same depth, pack,
        # LZ4 (plus the 4-byte uncompressed-size word its block headers
        # would need, util.c:423-429)
        ref_bytes = 0
        x0s = pos.min(axis=1)
        dxs = (pos.max(axis=1) - x0s).max()
        depth = qe.delta_to_depth(delta, 0.0, float(dxs))
        for d in range(3):
            bins = kernels.uniform_bin_index(jnp.asarray(pos[d]), depth,
                                             float(x0s[d]), float(dxs))
            words = np.asarray(bitpack.uniform_pack(bins, depth))
            comp = entropy.encode(words)
            ref_bytes += min(len(comp), words.nbytes) + 4

        ver = registry.newest(mnw.AlgoCode.TRIM)
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.TRIM, ver,
                               n),
            data=pos, acc=mnw.PositionAccuracy(delta=delta, width=W))])
        blob = api.compress_segment(seg, seed=1)
        overhead = len(blob) - ref_bytes
        # fixed metadata: segment+field+block headers, preludes, meta block
        assert overhead < 512, (len(blob), ref_bytes)


class TestSortV11:
    def test_nearly_sorted_ids_much_smaller(self):
        n = 50000
        rng = np.random.default_rng(0)
        ids = np.arange(n, dtype=np.uint64) + 1000  # Lagrangian order
        # a few percent swapped
        for _ in range(n // 50):
            i, j = rng.integers(0, n, 2)
            ids[i], ids[j] = ids[j], ids[i]

        def one(ver):
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.PTID, mnw.AlgoCode.SORT,
                                   ver, n),
                data=ids, acc=mnw.IDAccuracy(width=1024))])
            return api.compress_segment(seg, seed=1)

        b10 = one(semver.pack(1, 0, 0))
        b11 = one(semver.pack(1, 1, 0))
        assert len(b11) < 0.7 * len(b10)
        for blob in (b10, b11):
            out = api.decompress_segment(blob)
            np.testing.assert_array_equal(np.asarray(out.fields[0].data),
                                          ids)

    def test_v11_registered_alongside_newer(self):
        # newest is 1.2 since round 5; 1.1 must stay registered forever
        assert registry.supports(mnw.AlgoCode.SORT, semver.pack(1, 1, 0))
        assert semver.minor(registry.newest(mnw.AlgoCode.SORT)) == 2

    def test_v10_streams_still_decode(self):
        n = 3000
        rng = np.random.default_rng(1)
        ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.PTID, mnw.AlgoCode.SORT,
                               semver.pack(1, 0, 0), n),
            data=ids, acc=mnw.IDAccuracy(width=1024))])
        blob = api.compress_segment(seg, seed=2)
        out = api.decompress_segment(blob)
        np.testing.assert_array_equal(np.asarray(out.fields[0].data), ids)


class TestTrimV11Deltas:
    def _seg(self, ver, n=20000, W=32.0):
        rng = np.random.default_rng(4)
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)
        deltas = 10.0 ** rng.uniform(-3, -1, n).astype(np.float32)
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.TRIM, ver,
                               n),
            data=pos,
            acc=mnw.PositionAccuracy(delta=0.0, width=W, deltas=deltas))])
        return seg, pos, deltas, W

    @pytest.mark.parametrize("minor", [0, 1])
    def test_per_particle_deltas_roundtrip(self, minor):
        ver = semver.pack(1, minor, 0)
        seg, pos, deltas, W = self._seg(ver)
        blob = api.compress_segment(seg, seed=6)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, W - err)
        assert (err <= deltas[None, :]).all()

    def test_newest_trim_is_v11(self):
        v = registry.newest(mnw.AlgoCode.TRIM)
        assert semver.minor(v) == 1

    def test_uniform_path_wire_identical_across_versions(self):
        # v1.1 only re-specifies the Deltas-mode payload; uniform-depth
        # streams must match v1.0 byte-for-byte except the stamped version.
        n, W = 5000, 16.0
        rng = np.random.default_rng(5)
        pos = rng.uniform(0, W, (3, n)).astype(np.float32)

        def blob(ver):
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.TRIM,
                                   ver, n),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            return bytearray(api.compress_segment(seg, seed=1))

        b0 = blob(semver.pack(1, 0, 0))
        b1 = blob(semver.pack(1, 1, 0))
        assert len(b0) == len(b1)
        # differing bytes must be confined to the version field (offset
        # 24..28 in the FieldHeader) and the header checksum (offset 0..4)
        diff_offsets = [i for i, (a, b) in enumerate(zip(b0, b1)) if a != b]
        assert all(i < 28 for i in diff_offsets), diff_offsets[:10]


def test_diff_coil_wide_range_uint_roundtrip():
    """Deltas with |d| >= 2^30 produce zigzag values >= 2^31; the decode
    unzigzag must use a LOGICAL shift (the int32 spelling silently added
    2^31 to every such delta).  Wide-range UNSI data is the reachable
    case (hashes, offsets)."""
    n = 4096
    rng = np.random.default_rng(0)
    # values spanning almost the full u32 range -> huge adjacent deltas
    vals = rng.integers(0, 1 << 42, n, dtype=np.uint64)
    for algo in (mnw.AlgoCode.DIFF, mnw.AlgoCode.COIL):
        ver = registry.newest(algo)
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.UNSI, algo, ver, n),
            data=vals, acc=mnw.IntAccuracy())])
        blob = api.compress_segment(seg, seed=1)
        out = api.decompress_segment(blob)
        np.testing.assert_array_equal(np.asarray(out.fields[0].data), vals)


def test_unpack_chunks_rejects_bad_width_table():
    """A wire-sourced chunk-width byte > 32 must fail cleanly (the
    graceful-degradation contract), not IndexError inside the gather."""
    from minnow_c_tpu.algos import chunked
    body = np.zeros(64, dtype=np.uint32)
    widths = np.array([8, 255], dtype=np.uint8)
    with pytest.raises(ValueError, match="width"):
        chunked.unpack_chunks(body, widths)


@pytest.mark.parametrize("n", [1, 33])
def test_tiny_and_odd_segments_all_codecs(n):
    """Every codec must round-trip single-particle and odd-length
    segments for all five field types (word-pad and per-dim edge
    cases)."""
    from minnow_c_tpu.segment import api
    rng = np.random.default_rng(5 + n)
    W = 64.0
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    vel = rng.normal(0, 300, (3, n)).astype(np.float32)
    ids = rng.permutation(np.arange(n, dtype=np.uint64) * 7 % (1024 ** 3))
    unsf = np.abs(rng.normal(1, 2, n)).astype(np.float32)
    unsi = rng.integers(0, 1 << 40, n, dtype=np.uint64)
    for algo in (mnw.AlgoCode.TRIM, mnw.AlgoCode.DIFF, mnw.AlgoCode.CART,
                 mnw.AlgoCode.COIL, mnw.AlgoCode.OCTO, mnw.AlgoCode.SORT):
        ver = registry.newest(algo)
        fields = [
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, ver, n),
                      data=pos,
                      acc=mnw.PositionAccuracy(delta=1e-3, width=W)),
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.VELC, algo, ver, n),
                      data=vel, acc=mnw.VelocityAccuracy(delta=1.0)),
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.PTID, algo, ver, n),
                      data=ids, acc=mnw.IDAccuracy(width=1024)),
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.UNSF, algo, ver, n),
                      data=unsf, acc=mnw.FloatAccuracy(delta=1e-3)),
            mnw.Field(hd=mnw.FieldHeader(mnw.FieldCode.UNSI, algo, ver, n),
                      data=unsi, acc=mnw.IntAccuracy()),
        ]
        blob = api.compress_segment(mnw.Seg(fields=fields), seed=n)
        out = api.decompress_segment(blob)
        perr = np.abs(out.fields[0].data - pos)
        perr = np.minimum(perr, W - perr)
        assert (perr <= 1e-3).all()
        assert (np.abs(out.fields[1].data - vel) <= 1.0).all()
        assert (np.asarray(out.fields[2].data) == ids).all()
        assert (np.abs(out.fields[3].data - unsf) <= 1e-3).all()
        assert (np.asarray(out.fields[4].data) == unsi).all()


class TestChunkedDevicePath:
    """The device-resident bucketed chunked machinery (round 4) must be
    value/byte-identical to the numpy reference path -- it serves the
    same frozen wire."""

    def _roundtrip_streams(self):
        rng = np.random.default_rng(0)
        n = 50_000
        coherent = np.cumsum(
            rng.integers(-3, 4, n), dtype=np.int64).astype(np.uint32)
        spiky = coherent.copy()
        spiky[rng.integers(0, n, 50)] = rng.integers(
            0, 1 << 31, 50, dtype=np.int64).astype(np.uint32)
        allzero = np.zeros(n, dtype=np.uint32)
        wide = rng.integers(0, 1 << 32, n, dtype=np.int64).astype(
            np.uint32)
        return [coherent, spiky, allzero, wide,
                rng.integers(0, 7, 97).astype(np.uint32)]  # ragged tail

    def test_pack_unpack_parity(self, monkeypatch):
        import jax.numpy as jnp

        from minnow_c_tpu.algos import chunked
        monkeypatch.setattr(chunked, "use_device", lambda x: True)
        for z in self._roundtrip_streams():
            zc_h, w_h = chunked.chunk_widths(z)
            zc_d, w_d = chunked.chunk_widths_auto(jnp.asarray(z))
            np.testing.assert_array_equal(w_h, w_d)
            np.testing.assert_array_equal(zc_h, np.asarray(zc_d))
            body_h = chunked.pack_chunks(zc_h, w_h)
            body_d = chunked.pack_chunks_auto(zc_d, w_d)
            assert body_h == body_d
            back_h = chunked.unpack_chunks(
                np.frombuffer(body_h, dtype=np.uint32), w_h)
            back_d = chunked.unpack_chunks_auto(
                jnp.asarray(np.frombuffer(body_d, dtype=np.uint32)), w_d)
            np.testing.assert_array_equal(back_h, np.asarray(back_d))

    def test_codec_wire_identical_under_device_path(self, monkeypatch):
        """Coil/Sort encode+decode through the forced device path produce
        the same bytes and decoded values as the host path."""
        from minnow_c_tpu.algos import chunked
        from minnow_c_tpu.segment import api
        host_choice = chunked.use_device

        rng = np.random.default_rng(1)
        n, W = 16384, 64.0
        steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
        pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
        for algo, ver in ((mnw.AlgoCode.COIL, semver.pack(1, 0, 0)),
                          (mnw.AlgoCode.SORT, semver.pack(1, 0, 0)),
                          (mnw.AlgoCode.SORT, semver.pack(1, 1, 0))):
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, ver, n),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            blob_h = api.compress_segment(seg, seed=7)
            out_h = api.decompress_segment(blob_h)
            monkeypatch.setattr(chunked, "use_device", lambda x: True)
            blob_d = api.compress_segment(seg, seed=7)
            out_d = api.decompress_segment(blob_d)
            monkeypatch.setattr(chunked, "use_device", host_choice)
            assert blob_h == blob_d, (algo, ver)
            np.testing.assert_array_equal(
                np.asarray(out_h.fields[0].data),
                np.asarray(out_d.fields[0].data))


class TestCoilV11:
    """Coil v1.1: parametric chunk size + column-major bodies (round-5).
    The generic TestAllFieldTypes already exercises v1.1 via
    registry.newest; these pin the version-specific behavior."""

    def test_newest_resolves_v11(self):
        from minnow_c_tpu import semver as sv
        v = registry.newest(mnw.AlgoCode.COIL)
        assert (sv.major(v), sv.minor(v)) == (1, 1)

    def test_v10_streams_still_decode(self):
        import dataclasses
        from minnow_c_tpu import semver as sv
        seg, pos, *_ = seg_with(mnw.AlgoCode.COIL, n=3000)
        seg = mnw.Seg(fields=[
            mnw.Field(hd=dataclasses.replace(
                f.hd, algo_version=sv.pack(1, 0, 0)), data=f.data,
                acc=f.acc) for f in seg.fields])
        blob = api.compress_segment(seg, seed=2)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3

    def test_big_chunk_path_roundtrip(self, monkeypatch):
        """Force the 16384-element chunk format at test scale and check
        the host decode path round-trips (the device path is covered by
        test_device_vs_host_decode_parity and chip_smoke.py's delta
        phase)."""
        from minnow_c_tpu.algos import algo_coil_v1_1 as c11
        monkeypatch.setattr(c11, "BIG_PLANE", 30000)
        seg, pos, *_ = seg_with(mnw.AlgoCode.COIL, n=40000)
        blob = api.compress_segment(seg, seed=7)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3
        # wire really carries chunk_log2 = 14
        from minnow_c_tpu.algos.blocks import decode_block
        from minnow_c_tpu.segment import format as wire_fmt
        ws = wire_fmt.deserialize(blob if isinstance(blob, bytes)
                                  else bytes(blob))
        coil_f = [f for f in ws.fields
                  if f.field_code == int(mnw.FieldCode.POSN)][0]
        payload, _, _ = decode_block(coil_f.blocks[1])
        raw = np.ascontiguousarray(payload).view(np.uint8)
        assert int(raw[8]) == 14  # chunk_log2

    def test_small_plane_ratio_matches_v10(self):
        """At < 2^20 values the encoder keeps 256-element chunks, so
        v1.1 segments cost v1.0 + 4 bytes/plane (the chunk_log2 tag)."""
        from minnow_c_tpu import semver as sv
        import dataclasses
        seg11, *_ = seg_with(mnw.AlgoCode.COIL, n=50000, sorted_pos=True)
        seg10, *_ = seg_with(mnw.AlgoCode.COIL, n=50000, sorted_pos=True)
        seg10 = mnw.Seg(fields=[
            mnw.Field(hd=dataclasses.replace(
                f.hd, algo_version=sv.pack(1, 0, 0)), data=f.data,
                acc=f.acc) for f in seg10.fields])
        b11 = api.compress_segment(seg11, seed=3)
        b10 = api.compress_segment(seg10, seed=3)
        # 4 B/plane tag + LZ4 jitter from the shifted payload offsets
        assert len(b11) <= len(b10) * 1.005

    def test_device_vs_host_decode_parity(self, monkeypatch):
        """decode via the device chunked path == the host chunked path,
        bit for bit, on a big-chunk stream."""
        import jax.numpy as jnp
        from minnow_c_tpu.algos import algo_coil_v1_1 as c11
        from minnow_c_tpu.algos import chunked
        rng = np.random.default_rng(4)
        n = 3 * 16384 + 1000
        walk = np.cumsum(rng.integers(-30, 31, n), dtype=np.int64)
        bins = ((walk - walk.min()) % (1 << 14)).astype(np.uint32)
        codec = c11.CoilV1_1()
        old = c11.BIG_PLANE
        c11.BIG_PLANE = 16384
        try:
            payload, _ = codec._encode_plane(jnp.asarray(bins), 14)
        finally:
            c11.BIG_PLANE = old
        host = np.asarray(codec._decode_plane(payload, 0, n))
        np.testing.assert_array_equal(host, bins)
        monkeypatch.setattr(chunked, "use_device", lambda x: True)
        dev = np.asarray(codec._decode_plane(payload, 0, n))
        np.testing.assert_array_equal(dev, bins)


class TestSortV12:
    """Sort v1.2: parametric chunks + the order-free profile (round-5
    item 9 -- Sort's demonstrated niche)."""

    def test_newest_resolves_v12(self):
        from minnow_c_tpu import semver as sv
        v = registry.newest(mnw.AlgoCode.SORT)
        assert (sv.major(v), sv.minor(v)) == (1, 2)

    def test_ranked_roundtrip_all_fields(self):
        seg, pos, vel, ids, uf, ui = seg_with(mnw.AlgoCode.SORT, n=3000)
        blob = api.compress_segment(seg, seed=5)
        out = api.decompress_segment(blob)
        np.testing.assert_array_equal(np.asarray(out.fields[2].data), ids)
        np.testing.assert_array_equal(np.asarray(out.fields[4].data), ui)

    def test_order_free_scalar_roundtrip(self):
        """Patch 1 = order-free: decoded UNSI values are the sorted
        multiset of the input; the stream has no rank stream and is
        strictly smaller than the ranked encode."""
        from minnow_c_tpu import semver as sv
        rng = np.random.default_rng(8)
        n = 20000
        ui = (rng.permutation(1 << 20)[:n] + 7).astype(np.uint64)

        def seg_for(patch):
            hd = mnw.FieldHeader(mnw.FieldCode.UNSI, mnw.AlgoCode.SORT,
                                 sv.pack(1, 2, patch), n)
            return mnw.Seg(fields=[mnw.Field(
                hd=hd, data=ui, acc=mnw.IntAccuracy())])

        ranked = api.compress_segment(seg_for(0), seed=1)
        free = api.compress_segment(seg_for(1), seed=1)
        assert len(free) < len(ranked) * 0.75  # rank stream dropped
        out = api.decompress_segment(free)
        got = np.asarray(out.fields[0].data)
        np.testing.assert_array_equal(got, np.sort(ui))

    def test_order_free_rejects_3dim(self):
        from minnow_c_tpu import semver as sv
        import pytest
        n = 2048
        rng = np.random.default_rng(2)
        pos = rng.uniform(0, 64, (3, n)).astype(np.float32)
        hd = mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.SORT,
                             sv.pack(1, 2, 1), n)
        seg = mnw.Seg(fields=[mnw.Field(
            hd=hd, data=pos,
            acc=mnw.PositionAccuracy(delta=1e-3, width=64.0))])
        with pytest.raises(ValueError, match="order-free"):
            api.compress_segment(seg, seed=1)

    def test_order_free_wins_on_dense_ids(self):
        """The niche row (VERDICT item 9): on a dense permutation ID
        field, order-free Sort beats Coil -- the repo's otherwise-best
        codec -- outright."""
        from minnow_c_tpu import semver as sv
        rng = np.random.default_rng(9)
        n = 100_000
        ids = rng.permutation(n).astype(np.uint64)

        def one(algo, ver):
            hd = mnw.FieldHeader(mnw.FieldCode.UNSI, algo, ver, n)
            return len(api.compress_segment(mnw.Seg(fields=[mnw.Field(
                hd=hd, data=ids, acc=mnw.IntAccuracy())]), seed=1))

        sort_free = one(mnw.AlgoCode.SORT, sv.pack(1, 2, 1))
        coil = one(mnw.AlgoCode.COIL, registry.newest(mnw.AlgoCode.COIL))
        assert sort_free < coil * 0.25, (sort_free, coil)

    def test_v11_streams_still_decode(self):
        import dataclasses
        from minnow_c_tpu import semver as sv
        seg, pos, *_ = seg_with(mnw.AlgoCode.SORT, n=3000)
        seg = mnw.Seg(fields=[
            mnw.Field(hd=dataclasses.replace(
                f.hd, algo_version=sv.pack(1, 1, 0)), data=f.data,
                acc=f.acc) for f in seg.fields])
        blob = api.compress_segment(seg, seed=2)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3

    def test_big_chunk_kernel_parity(self):
        """v1.2 round trip on a big-chunk ranked stream."""
        import jax.numpy as jnp
        from minnow_c_tpu.algos import algo_coil_v1_1 as c11
        from minnow_c_tpu.algos import algo_sort_v1_2 as s12
        import unittest.mock as mock
        rng = np.random.default_rng(5)
        n = 2 * 16384 + 777
        bins = rng.integers(0, 1 << 16, n, dtype=np.int64).astype(
            np.uint32)
        codec = s12.SortV1_2()
        with mock.patch.object(s12, "BIG_PLANE", 16384):
            payload, _ = codec._encode_plane(jnp.asarray(bins), 16)
        out = np.asarray(codec._decode_plane(payload, 0, n))
        np.testing.assert_array_equal(out, bins)


def test_coil11_fused_decode_bit_parity():
    """decompress_segment(fused=True) must produce bit-identical floats
    to the generic path for Coil v1.1 fields (the fused hook: plane bins
    + the Diff-style undo tail)."""
    seg, pos, vel, ids, uf, ui = seg_with(mnw.AlgoCode.COIL, n=9000)
    blob = api.compress_segment(seg, seed=11)
    a = api.decompress_segment(blob, fused=True)
    b = api.decompress_segment(blob, fused=False)
    for fa, fb in zip(a.fields, b.fields):
        np.testing.assert_array_equal(np.asarray(fa.data),
                                      np.asarray(fb.data))


def test_sort_orderfree_rejects_wide_range_unsi():
    """Order-free + u64 range > 2^32 would split into lo+hi planes and
    sort only lo -- silent corruption (code-review finding, round 5);
    must be rejected at compress time."""
    from minnow_c_tpu import semver as sv
    rng = np.random.default_rng(12)
    n = 4096
    ui = rng.integers(0, 1 << 40, n, dtype=np.int64).astype(np.uint64)
    hd = mnw.FieldHeader(mnw.FieldCode.UNSI, mnw.AlgoCode.SORT,
                         sv.pack(1, 2, 1), n)
    seg = mnw.Seg(fields=[mnw.Field(hd=hd, data=ui,
                                    acc=mnw.IntAccuracy())])
    with pytest.raises(ValueError, match="2\\^32"):
        api.compress_segment(seg, seed=1)
    # the ranked profile handles the same data losslessly
    hd2 = mnw.FieldHeader(mnw.FieldCode.UNSI, mnw.AlgoCode.SORT,
                          sv.pack(1, 2, 0), n)
    seg2 = mnw.Seg(fields=[mnw.Field(hd=hd2, data=ui,
                                     acc=mnw.IntAccuracy())])
    out = api.decompress_segment(api.compress_segment(seg2, seed=1))
    np.testing.assert_array_equal(np.asarray(out.fields[0].data), ui)


class TestOctoV11:
    """Octo v1.1: the Morton stream on the v1.1 chunked layout (kernel
    decode at scale); v1.0 streams stay decodable."""

    def test_newest_resolves_v11(self):
        from minnow_c_tpu import semver as sv
        v = registry.newest(mnw.AlgoCode.OCTO)
        assert (sv.major(v), sv.minor(v)) == (1, 1)

    def test_v10_streams_still_decode(self):
        import dataclasses
        from minnow_c_tpu import semver as sv
        seg, pos, *_ = seg_with(mnw.AlgoCode.OCTO, n=3000)
        seg = mnw.Seg(fields=[
            mnw.Field(hd=dataclasses.replace(
                f.hd, algo_version=sv.pack(1, 0, 0)), data=f.data,
                acc=f.acc) for f in seg.fields])
        blob = api.compress_segment(seg, seed=2)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3

    def test_big_chunk_morton_roundtrip(self, monkeypatch):
        """Force the 16384-chunk Morton stream at test scale; host
        decode must round-trip (the kernel path is smoke-gated)."""
        from minnow_c_tpu.algos import algo_coil_v1_1 as c11
        monkeypatch.setattr(c11, "BIG_PLANE", 30000)
        seg, pos, vel, ids, uf, ui = seg_with(mnw.AlgoCode.OCTO, n=40000)
        blob = api.compress_segment(seg, seed=7)
        out = api.decompress_segment(blob)
        err = np.abs(np.asarray(out.fields[0].data) - pos)
        err = np.minimum(err, 64.0 - err)
        assert err.max() <= 1e-3
        np.testing.assert_array_equal(np.asarray(out.fields[2].data), ids)
