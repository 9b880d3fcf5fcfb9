"""L1 kernel tests: table-driven exact cases + randomized round-trips,
mirroring the reference test strategy (test/compress_util_test.c), plus
bit-exact parity checks against the compiled reference oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from minnow_c_tpu.ops import kernels
from tests import ref_oracle


def np32(*vals):
    return np.array(vals, dtype=np.float32)


class TestOracleParityExtended:
    """Bit-exact parity vs the compiled reference C for the remaining
    util.c kernels (periodic wrap family, byte transpose, u8 delta,
    per-element-depth bin index)."""

    @pytest.fixture(autouse=True)
    def _need_oracle(self):
        if ref_oracle.lib() is None:
            pytest.skip("reference oracle unavailable")

    def test_periodic_parity(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(-10.0, 20.0, 4096).astype(np.float32)
        ours = np.asarray(kernels.periodic(jnp.asarray(x), 10.0))
        ref = ref_oracle.ref_periodic(x, 10.0)
        np.testing.assert_array_equal(ours, ref)

    def test_undo_periodic_parity(self):
        rng = np.random.default_rng(2)
        x = (rng.uniform(9.0, 11.0, 4096).astype(np.float32) % 10.0)
        ours = np.asarray(kernels.undo_periodic(jnp.asarray(x), 10.0))
        ref = ref_oracle.ref_undo_periodic(x, 10.0)
        np.testing.assert_array_equal(ours, ref)

    def test_u64_periodic_parity(self):
        rng = np.random.default_rng(3)
        x = rng.integers(0, 2000, 4096).astype(np.uint64)
        ours = np.asarray(kernels.u64_periodic(jnp.asarray(x), 1024))
        ref = ref_oracle.ref_u64_periodic(x, 1024)
        np.testing.assert_array_equal(ours, ref)

    def test_u64_undo_periodic_parity(self):
        rng = np.random.default_rng(4)
        # cluster straddling the boundary, like Lagrangian ID coords
        x = ((rng.integers(1000, 1100, 4096) % 1024)).astype(np.uint64)
        ours = np.asarray(kernels.u64_undo_periodic(jnp.asarray(x), 1024))
        ref = ref_oracle.ref_u64_undo_periodic(x, 1024)
        np.testing.assert_array_equal(ours, ref)

    def test_transpose_bytes_parity(self):
        rng = np.random.default_rng(5)
        x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(
            np.uint32)
        ours = np.asarray(kernels.u32_transpose_bytes(jnp.asarray(x)))
        ref = ref_oracle.ref_transpose_bytes(x)
        np.testing.assert_array_equal(ours, ref)
        back = np.asarray(kernels.u32_undo_transpose_bytes(
            jnp.asarray(ref)))
        ref_back = ref_oracle.ref_undo_transpose_bytes(ref)
        np.testing.assert_array_equal(back, ref_back)

    def test_u8_delta_parity(self):
        rng = np.random.default_rng(6)
        x = rng.integers(0, 256, 4096).astype(np.uint8)
        ours = np.asarray(kernels.u8_delta_encode(jnp.asarray(x)))
        ref = ref_oracle.ref_u8_delta_encode(x)
        # Reference keeps y[0] = x[0]; wraparound subtraction elsewhere.
        np.testing.assert_array_equal(ours, ref)

    def test_per_element_bin_index_parity(self):
        rng = np.random.default_rng(7)
        x = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
        levels = rng.integers(1, 20, 4096).astype(np.uint8)
        ours = np.asarray(kernels.bin_index(jnp.asarray(x),
                                            jnp.asarray(levels), 0.0, 1.0))
        ref = ref_oracle.ref_bin_index(x, levels, 0.0, 1.0)
        np.testing.assert_array_equal(ours.astype(np.uint64), ref)


class TestMinMax:
    def test_basic(self):
        mn, mx = kernels.minmax(jnp.asarray(np32(3, 1, -2, 8, 0)))
        assert float(mn) == -2 and float(mx) == 8

    def test_single(self):
        mn, mx = kernels.minmax(jnp.asarray(np32(5)))
        assert float(mn) == 5 and float(mx) == 5

    def test_u64(self):
        x = jnp.asarray(np.array([7, 2, 9, 2], dtype=np.uint64))
        mn, mx = kernels.u64_minmax(x)
        assert int(mn) == 2 and int(mx) == 9


class TestPeriodic:
    def test_wrap(self):
        # Values within one L of range (util_Periodic contract, util.c:70-84)
        x = np32(-1.0, 0.0, 5.0, 10.0, 11.0)
        out = np.asarray(kernels.periodic(jnp.asarray(x), 10.0))
        np.testing.assert_array_equal(out, np32(9.0, 0.0, 5.0, 0.0, 1.0))

    def test_u64_wrap(self):
        x = np.array([0, 5, 10, 14], dtype=np.uint64)
        out = np.asarray(kernels.u64_periodic(jnp.asarray(x), 10))
        np.testing.assert_array_equal(
            out, np.array([0, 5, 0, 4], dtype=np.uint64))

    def test_undo_contiguous(self):
        # Cluster straddling the boundary: x[0]=9.5 anchors; 0.5 unwraps to
        # 10.5 (util_UndoPeriodic, util.c:97-113).
        x = np32(9.5, 0.5, 9.0)
        out = np.asarray(kernels.undo_periodic(jnp.asarray(x), 10.0))
        np.testing.assert_array_equal(out, np32(9.5, 10.5, 9.0))

    def test_undo_low_anchor(self):
        x = np32(0.5, 9.5, 1.0)
        out = np.asarray(kernels.undo_periodic(jnp.asarray(x), 10.0))
        np.testing.assert_array_equal(out, np32(0.5, -0.5, 1.0))

    def test_undo_then_wrap_roundtrip(self):
        rng = np.random.default_rng(0)
        base = rng.uniform(9.0, 11.0, 1000).astype(np.float32) % 10.0
        un = np.asarray(kernels.undo_periodic(jnp.asarray(base), 10.0))
        assert np.max(un) - np.min(un) < 5.0  # contiguous now
        re = np.asarray(kernels.periodic(jnp.asarray(un), 10.0))
        np.testing.assert_allclose(re, base, atol=1e-5)

    def test_u64_undo(self):
        # util_U64UndoPeriodic: element 0 is the anchor, then lift if any
        # value went negative (util.c:115-143).
        x = np.array([9, 1, 8], dtype=np.uint64)
        out = np.asarray(kernels.u64_undo_periodic(jnp.asarray(x), 10))
        np.testing.assert_array_equal(
            out, np.array([9, 11, 8], dtype=np.uint64))

        x2 = np.array([1, 9, 2], dtype=np.uint64)
        out2 = np.asarray(kernels.u64_undo_periodic(jnp.asarray(x2), 10))
        # 9 unwraps to -1; min<0 lifts all by 10.
        np.testing.assert_array_equal(
            out2, np.array([11, 9, 12], dtype=np.uint64))


class TestBinIndex:
    def test_uniform_exact_vs_oracle(self):
        if ref_oracle.lib() is None:
            pytest.skip("reference oracle unavailable")
        rng = np.random.default_rng(1)
        for level in (0, 1, 4, 11, 24):
            x = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
            ours = np.asarray(
                kernels.uniform_bin_index(jnp.asarray(x), level, 0.0, 1.0))
            ref = ref_oracle.ref_uniform_bin_index(x, level, 0.0, 1.0)
            np.testing.assert_array_equal(ours.astype(np.uint64), ref)

    def test_uniform_clamps(self):
        # Out-of-range values clamp (util.c:186-190).
        x = np32(-0.01, 1.01, 0.5)
        out = np.asarray(
            kernels.uniform_bin_index(jnp.asarray(x), 3, 0.0, 1.0))
        np.testing.assert_array_equal(out, np.array([0, 7, 4],
                                                    dtype=np.uint32))

    def test_per_element_levels(self):
        x = np32(0.5, 0.5, 0.5)
        lv = np.array([1, 2, 3], dtype=np.uint8)
        out = np.asarray(
            kernels.bin_index(jnp.asarray(x), jnp.asarray(lv), 0.0, 1.0))
        np.testing.assert_array_equal(out, np.array([1, 2, 4],
                                                    dtype=np.uint32))

    def test_undo_recovers_bin(self):
        # Lossy-stage oracle: BinIndex(UndoBinIndex(idx)) == idx
        # (compress_util_test.c:294-341 pattern).
        rng = np.random.default_rng(2)
        level = 9
        idx = rng.integers(0, 1 << level, 8192).astype(np.uint32)
        from minnow_c_tpu.ops import rng as mrng
        key = mrng.field_key_arr(7, 0, 0)
        x = kernels.undo_uniform_bin_index(jnp.asarray(idx), level, 0.0, 1.0,
                                           key)
        back = np.asarray(
            kernels.uniform_bin_index(x, level, 0.0, 1.0))
        np.testing.assert_array_equal(back, idx)

    def test_undo_per_element_recovers_bin(self):
        rng = np.random.default_rng(3)
        lv = rng.integers(0, 12, 4096).astype(np.uint8)
        idx = (rng.integers(0, 1 << 20, 4096) %
               (1 << lv.astype(np.uint32))).astype(np.uint32)
        from minnow_c_tpu.ops import rng as mrng
        key = mrng.field_key_arr(8, 0, 0)
        x = kernels.undo_bin_index(jnp.asarray(idx), jnp.asarray(lv), 0.0,
                                   1.0, key)
        back = np.asarray(kernels.bin_index(x, jnp.asarray(lv), 0.0, 1.0))
        np.testing.assert_array_equal(back, idx)

    def test_undo_deterministic(self):
        idx = jnp.asarray(np.arange(100, dtype=np.uint32) % 8)
        from minnow_c_tpu.ops import rng as mrng
        key = mrng.field_key_arr(3, 0, 0)
        a = np.asarray(kernels.undo_uniform_bin_index(idx, 3, 0.0, 1.0, key))
        b = np.asarray(kernels.undo_uniform_bin_index(idx, 3, 0.0, 1.0, key))
        np.testing.assert_array_equal(a, b)


class TestTranspose:
    def test_exact(self):
        x = np.array([0x04030201, 0x08070605], dtype=np.uint32)
        out = np.asarray(kernels.u32_transpose_bytes(jnp.asarray(x)))
        np.testing.assert_array_equal(
            out, np.array([1, 5, 2, 6, 3, 7, 4, 8], dtype=np.uint8))

    def test_roundtrip_random(self):
        rng = np.random.default_rng(4)
        x = rng.integers(0, 2**32, 16384, dtype=np.uint64).astype(np.uint32)
        t = kernels.u32_transpose_bytes(jnp.asarray(x))
        back = np.asarray(kernels.u32_undo_transpose_bytes(t))
        np.testing.assert_array_equal(back, x)


class TestDelta:
    def test_exact(self):
        x = np.array([5, 7, 6, 6, 250], dtype=np.uint8)
        enc = np.asarray(kernels.u8_delta_encode(jnp.asarray(x)))
        np.testing.assert_array_equal(
            enc, np.array([5, 2, 255, 0, 244], dtype=np.uint8))
        back = np.asarray(kernels.u8_undo_delta_encode(jnp.asarray(enc)))
        np.testing.assert_array_equal(back, x)

    def test_empty(self):
        x = np.zeros(0, dtype=np.uint8)
        assert kernels.u8_delta_encode(jnp.asarray(x)).shape == (0,)

    def test_roundtrip_random(self):
        rng = np.random.default_rng(5)
        x = rng.integers(0, 256, 100000, dtype=np.int64).astype(np.uint8)
        enc = kernels.u8_delta_encode(jnp.asarray(x))
        back = np.asarray(kernels.u8_undo_delta_encode(enc))
        np.testing.assert_array_equal(back, x)


def test_constant_plane_bins_to_zero():
    """dx == 0 (constant plane) makes delta = 0/0 = NaN; the bin index
    must be pinned to 0 deterministically -- NaN->int conversion is
    hardware-defined (0 on XLA:CPU, unspecified on Mosaic), and the
    reference C is UB here (util.c:159-166, documented divergence)."""
    import jax.numpy as jnp
    from minnow_c_tpu.ops import kernels
    x = jnp.full((64,), 3.25, jnp.float32)
    out = np.asarray(kernels.uniform_bin_index(x, 11, 3.25, 0.0))
    np.testing.assert_array_equal(out, np.zeros(64, np.uint32))
    depths = jnp.full((64,), 7, jnp.uint32)
    out = np.asarray(kernels.bin_index(x, depths, 3.25, 0.0))
    np.testing.assert_array_equal(out, np.zeros(64, np.uint32))


def test_constant_plane_encode_roundtrip():
    """A constant field plane must encode to deterministic bytes and
    decode back exactly (dx = 0 => every decoded value is x0)."""
    import jax.numpy as jnp
    from minnow_c_tpu.ops import fastpath, rng as _rng
    x = jnp.full((4096,), 17.5, jnp.float32)
    w1, x0, rng_v = fastpath.fast_uniform_encode(x, 11)
    w2, _, _ = fastpath.fast_uniform_encode(x, 11)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(w1),
                                  np.zeros_like(np.asarray(w1)))
    key = _rng.field_key_arr(3, 0, 0)
    out = fastpath.fast_uniform_decode(w1, key, 11, 4096, x0, rng_v)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.full(4096, 17.5, np.float32))


class TestExactDiv:
    """kernels.exact_div corrects the backend's quotient with an exact f64
    residual: the IEEE f32 quotient, the bin map's wire-defining division
    on every backend.  Pathological operands must stay finite where a
    plain divide is, and never turn into NaN bins."""

    def _corrected(self, x, d):
        import jax
        import jax.numpy as jnp
        from minnow_c_tpu.ops import kernels
        f = jax.jit(lambda a, b: kernels.exact_div(a, b))
        return np.asarray(f(jnp.float32(x), jnp.float32(d)))

    def test_normal_operands_correctly_rounded(self):
        rng = np.random.default_rng(11)
        x = rng.uniform(1e-3, 1e3, 4096).astype(np.float32)
        d = rng.uniform(1e-3, 1e3, 4096).astype(np.float32)
        np.testing.assert_array_equal(self._corrected(x, d), x / d)

    def test_huge_operands_fall_back_finite(self):
        # a * 4097 overflows inside the split; plain divide is finite
        x = np.float32(3e38)
        d = np.float32(2.0)
        out = self._corrected(x, d)
        assert np.isfinite(out)
        np.testing.assert_array_equal(out, x / d)

    def test_subnormal_divisor_falls_back(self):
        """Subnormal d yields exactly the backend's plain divide (XLA:CPU
        flushes subnormals to zero, so that may itself be inf).
        Critically: never NaN."""
        import jax
        import jax.numpy as jnp
        d = np.float32(1e-40)  # subnormal
        x = np.float32(1e-30)
        out = self._corrected(x, d)
        plain = np.asarray(jax.jit(lambda a, b: a / b)(
            jnp.float32(x), jnp.float32(d)))
        assert not np.isnan(out)
        np.testing.assert_array_equal(out, plain)

    def test_genuine_infinity_stays_infinite(self):
        # x/d legitimately overflows -> both paths inf; result must be inf
        out = self._corrected(np.float32(3e38), np.float32(1e-10))
        assert np.isinf(out)
