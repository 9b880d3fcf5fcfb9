"""The codec's XLA device paths against numpy/native oracles: decode
(unpack + dither + un-bin + rewrap), encode (unwrap + min/max + bin +
pack), the rows pack/unpack, the u32 prefix sum of the delta codecs and
the chunked delta layout, at tile-sized and ragged lengths.

Float decodes are compared within one rounding: XLA may contract
``x0 + dx*t`` into a fused multiply-add, which the one-rounding-per-op
numpy oracle does not."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from minnow_c_tpu.ops import bitpack, fastpath, native
from minnow_c_tpu.ops import rng as _rng

SMALL = 1 << 14
W = 64.0


def _bins(rng, shape, width):
    return rng.integers(0, 1 << width, shape,
                        dtype=np.uint64).astype(np.uint32)


def _decode_oracle(bins, key, width, x0, dx, box=None, ctr0=0):
    """Strict per-op numpy decode; returns (values, rounding magnitude)."""
    u = _rng.uniform_dither_np(key, bins.shape, ctr0=ctr0)
    bw = np.float32(dx) / np.float32(1 << width)
    prod = bw * (bins.astype(np.float32) + u)
    y = np.float32(x0) + prod
    mag = np.maximum(np.abs(prod), np.abs(y))
    if box is not None:
        b = np.float32(box)
        y = np.where(y >= b, y - b, y)
        y = np.where(y < 0, y + b, y)
        mag = np.maximum(mag, np.abs(y))
    return y.astype(np.float32), mag


def _assert_one_rounding(got, want, mag, box=None):
    diff = np.abs(np.asarray(got, np.float64) - want)
    if box is not None:
        diff = np.minimum(diff, box - diff)
    assert np.all(diff <= np.spacing(mag.astype(np.float32))), \
        f"{int((diff > np.spacing(mag)).sum())} values off the oracle"


def _undo_periodic_np(x, box):
    L = np.float32(box)
    x0 = x[0]
    x = np.where(x - x0 >= L / 2, x - L, x)
    return np.where(x - x0 < -L / 2, x + L, x).astype(np.float32)


def _div_bins_np(x, level, x0, dx):
    with np.errstate(invalid="ignore", divide="ignore"):
        delta = (x - np.float32(x0)) / np.float32(dx)
        scaled = delta * np.float32(1 << level)
    out = np.where(delta < 0, 0, np.where(
        delta >= 1, (1 << level) - 1,
        np.nan_to_num(scaled).astype(np.int64)))
    return np.where(np.isnan(delta), 0, out).astype(np.uint32)


def _recip_bins_np(x, x0, recip, box, anchor, width):
    if box is not None:
        half = np.float32(box) * np.float32(0.5)
        x = np.where(x - anchor >= half, x - np.float32(box), x)
        x = np.where(x - anchor < -half, x + np.float32(box), x)
    nb = np.float32(1 << width)
    with np.errstate(invalid="ignore"):
        scaled = ((x - np.float32(x0)) * np.float32(recip)) * nb
    si = np.where(scaled < 0, 0, np.where(
        scaled >= nb, (1 << width) - 1,
        np.nan_to_num(scaled).astype(np.int64)))
    return np.where(np.isnan(scaled), 0, si).astype(np.uint32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_extra", [0, 4096])
@pytest.mark.parametrize("width", [1, 11, 16, 24])
def test_decode_matches_oracle(width, n_extra):
    n = SMALL + n_extra
    rng = np.random.default_rng(width)
    bins = _bins(rng, n, width)
    words = jnp.asarray(native.uniform_pack_host(bins, width))
    key = _rng.field_key_arr(9, 1, 2)
    got = np.asarray(fastpath.fast_uniform_decode(
        words, key, width, n, 1.5, 32.0, periodic_width=W))
    want, mag = _decode_oracle(bins, np.asarray(key), width, 1.5, 32.0, W)
    _assert_one_rounding(got, want, mag, W)


@pytest.mark.parametrize("width", [1, 14, 24])
def test_batched_decode_rows_match_oracle(width):
    """The batched reader's decode (all blocks of a dim in one program)
    against the oracle, per block, 32-aligned but not tile-sized."""
    from minnow_c_tpu.parallel import snapshot
    n, B = SMALL + 64, 4
    rng = np.random.default_rng(width)
    bins = _bins(rng, (B, n), width)
    words = np.stack([native.uniform_pack_host(b, width) for b in bins])
    key = np.asarray(_rng.field_key_arr(9, 0, 0))
    x0 = np.linspace(0.0, 3.0, B).astype(np.float32)
    got = np.asarray(snapshot._batched_float_decode(
        jnp.asarray(words)[:, None], jnp.asarray(x0)[:, None],
        jnp.full((B,), W, jnp.float32), jnp.asarray(key), width, n, True,
        jnp.float32(W)))[:, 0]
    for b in range(B):
        want, mag = _decode_oracle(bins[b], key, width, x0[b], W, W)
        _assert_one_rounding(got[b], want, mag, W)


@pytest.mark.parametrize("width", [1, 10, 24, 32])
def test_unpack_rows_match_native(width):
    """The ID reader's vmapped unpack, row by row, == the packed values."""
    n, R = SMALL + 96, 3
    rng = np.random.default_rng(width)
    bins = _bins(rng, (R, n), width)
    words = np.stack([native.uniform_pack_host(b, width) for b in bins])
    got = np.asarray(jax.vmap(lambda r: bitpack.uniform_unpack(
        r, width, n))(jnp.asarray(words)))
    np.testing.assert_array_equal(got, bins)


def test_pack_rows_rejects_unaligned():
    with pytest.raises(ValueError, match="32"):
        bitpack.uniform_pack_rows(jnp.zeros((2, 33), jnp.uint32), 4)


def test_decode_no_periodic():
    n = SMALL
    rng = np.random.default_rng(0)
    bins = _bins(rng, n, 9)
    words = jnp.asarray(native.uniform_pack_host(bins, 9))
    key = _rng.field_key_arr(3, 0, 0)
    got = np.asarray(fastpath.fast_uniform_decode(words, key, 9, n, -2.0,
                                                  4.0))
    want, mag = _decode_oracle(bins, np.asarray(key), 9, -2.0, 4.0)
    _assert_one_rounding(got, want, mag)


def test_decode_tiles_with_counter_offset():
    """A stream decoded in two tiles (the second at its global counter
    offset ``ctr0``) equals the whole-stream decode bit for bit."""
    width = 13
    n1, n2 = 1 << 15, (1 << 14) + 900
    rng = np.random.default_rng(7)
    bins = _bins(rng, n1 + n2, width)
    key = _rng.field_key_arr(2, 0, 1)

    def dec(b, ctr0):
        words = jnp.asarray(native.uniform_pack_host(b, width))
        return np.asarray(fastpath.fast_uniform_decode(
            words, key, width, b.shape[0], 0.25, 16.0, periodic_width=16.0,
            ctr0=ctr0))

    whole = dec(bins, 0)
    parts = np.concatenate([dec(bins[:n1], 0), dec(bins[n1:], n1)])
    np.testing.assert_array_equal(parts.view(np.uint32),
                                  whole.view(np.uint32))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

class TestEncode:
    @pytest.mark.parametrize("width", [1, 11, 24])
    @pytest.mark.parametrize("n_extra", [0, 4096])
    def test_encode_matches_oracle(self, width, n_extra):
        n = SMALL + n_extra
        rng = np.random.default_rng(width + n_extra)
        x = rng.uniform(0, W, n).astype(np.float32)
        words, x0, rv = fastpath.fast_uniform_encode(
            jnp.asarray(x), width, periodic_width=W)
        xu = _undo_periodic_np(x, W)
        lo, hi = xu.min(), xu.max()
        assert float(x0) == float(lo) and float(rv) == float(hi - lo)
        want = native.uniform_pack_host(
            _div_bins_np(xu, width, lo, hi - lo), width)
        np.testing.assert_array_equal(np.asarray(words), want)

    @pytest.mark.parametrize("width", [1, 14, 24])
    def test_pack_matches_native(self, width):
        n = SMALL + 900                 # not a multiple of 32
        rng = np.random.default_rng(width)
        bins = _bins(rng, n, width)
        got = np.asarray(bitpack.uniform_pack(jnp.asarray(bins), width))
        np.testing.assert_array_equal(
            got, native.uniform_pack_host(bins, width))

    @pytest.mark.parametrize("width", [1, 14, 24])
    def test_pack_rows_matches_per_row(self, width):
        n, R = SMALL + 64, 3
        rng = np.random.default_rng(width)
        bins = _bins(rng, (R, n), width)
        got = np.asarray(bitpack.uniform_pack_rows(jnp.asarray(bins), width))
        for r in range(R):
            np.testing.assert_array_equal(
                got[r], native.uniform_pack_host(bins[r], width))

    def test_pack_long_ragged(self):
        width = 13
        n = (1 << 15) + (1 << 14) + 900
        bins = _bins(np.random.default_rng(3), n, width)
        got = np.asarray(bitpack.uniform_pack(jnp.asarray(bins), width))
        np.testing.assert_array_equal(
            got, native.uniform_pack_host(bins, width))

    def test_encode_decode_closure(self):
        """encode -> decode round trip within one bin."""
        n, width = SMALL, 12
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.uniform(0, W, n).astype(np.float32))
        words, x0, rv = fastpath.fast_uniform_encode(x, width,
                                                     periodic_width=W)
        key = _rng.field_key_arr(1, 0, 0)
        y = np.asarray(fastpath.fast_uniform_decode(
            words, key, width, n, x0, rv, periodic_width=W))
        err = np.abs(y - np.asarray(x))
        err = np.minimum(err, W - err)
        assert err.max() <= float(rv) / (1 << width) * 1.01


def test_unpack_many_rows():
    n, R, width = 128, 9, 7
    bins = _bins(np.random.default_rng(0), (R, n), width)
    words = np.stack([native.uniform_pack_host(b, width) for b in bins])
    got = np.asarray(jax.vmap(lambda r: bitpack.uniform_unpack(
        r, width, n))(jnp.asarray(words)))
    np.testing.assert_array_equal(got, bins)


def test_batched_decode_many_blocks():
    """Many small blocks through the batched reader's decode, per block
    against the oracle (x0 and range differ per block)."""
    from minnow_c_tpu.parallel import snapshot
    n, B, width = 160, 6, 11
    rng = np.random.default_rng(1)
    bins = _bins(rng, (B, n), width)
    words = np.stack([native.uniform_pack_host(b, width) for b in bins])
    key = np.asarray(_rng.field_key_arr(4, 0, 2))
    x0 = rng.uniform(0, 1, B).astype(np.float32)
    dx = rng.uniform(1, 2, B).astype(np.float32)
    got = np.asarray(snapshot._batched_float_decode(
        jnp.asarray(words)[:, None], jnp.asarray(x0)[:, None],
        jnp.asarray(dx), jnp.asarray(key), width, n, True,
        jnp.float32(W)))[:, 0]
    for b in range(B):
        want, mag = _decode_oracle(bins[b], key, width, x0[b], dx[b], W)
        _assert_one_rounding(got[b], want, mag, W)


def test_float_depth_over_24_rejected():
    """Float depths cap at 24 bits (f32 mantissa): the SPMD codec refuses
    a wider one (IDs, which have no float stage, unpack up to 32 bits --
    see test_unpack_rows_match_native[32])."""
    from minnow_c_tpu.parallel.sharding import ShardedSnapshotCodec, make_mesh
    with pytest.raises(ValueError, match="24"):
        ShardedSnapshotCodec(mesh=make_mesh(1), box=W, pos_depth=25,
                             vel_depth=12, id_grid=1024)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", [SMALL + 64, 1000, 96])
def test_rows_stats_match_numpy(periodic, n):
    """Per-row min/max of the anchored unwrap == numpy, including wrapped
    periodic clusters and rows that are not 32-aligned."""
    from minnow_c_tpu.parallel.sharding import _rows_stats_raw
    R = 6
    rng = np.random.default_rng(n + periodic)
    centers = rng.uniform(0, W, (R, 1))
    x = ((centers + rng.normal(0, 3.0, (R, n))) % W).astype(np.float32)
    mn, mx = _rows_stats_raw(jnp.asarray(x), W if periodic else None)
    for r in range(R):
        xu = _undo_periodic_np(x[r], W) if periodic else x[r]
        assert float(mn[r]) == float(xu.min())
        assert float(mx[r]) == float(xu.max())


def test_batched_stats_match_rows_stats():
    """The snapshot writer's stats pass == per-row stats reduced per
    block (x0 per dim, range shared across the block's dims)."""
    from minnow_c_tpu.parallel import snapshot
    from minnow_c_tpu.parallel.sharding import _rows_stats_raw
    x = np.random.default_rng(3).uniform(
        0, W, (4, 3, 1 << 10)).astype(np.float32)
    x0, rng_b = snapshot._batched_stats_pos(jnp.asarray(x), W)
    mn, mx = _rows_stats_raw(jnp.asarray(x.reshape(12, -1)), W)
    np.testing.assert_array_equal(np.asarray(x0),
                                  np.asarray(mn).reshape(4, 3))
    np.testing.assert_array_equal(
        np.asarray(rng_b), (np.asarray(mx) - np.asarray(mn)).reshape(
            4, 3).max(axis=1))


@pytest.mark.parametrize("width", [1, 14, 24])
def test_unpack_variants_agree(width):
    """The blocked unpack (the default), the gather-based funnel read and
    the dense bit-matrix unpack give the same values."""
    n = SMALL + 64
    bins = _bins(np.random.default_rng(100 + width), n, width)
    words = jnp.asarray(native.uniform_pack_host(bins, width))
    for fn in (bitpack.uniform_unpack, bitpack.uniform_unpack_gather,
               bitpack.uniform_unpack_dense):
        np.testing.assert_array_equal(np.asarray(fn(words, width, n)), bins)


@pytest.mark.parametrize("n", [1 << 14, (1 << 16) + (1 << 14),
                               (1 << 19) + (1 << 14) + 1000, 97])
def test_cumsum_u32_wraps(n):
    """The delta codecs' prefix sum (jnp.cumsum in u32) == numpy's exact
    sum mod 2^32."""
    x = np.random.default_rng(n).integers(0, 1 << 32, n,
                                          dtype=np.int64).astype(np.uint32)
    ref = np.cumsum(x.astype(np.uint64)).astype(np.uint32)
    got = np.asarray(jax.jit(lambda v: jnp.cumsum(v, dtype=jnp.uint32))(x))
    np.testing.assert_array_equal(got, ref)


class TestChunkedDelta:
    """The Coil v1.1 chunked-width delta plane on the device path (forced
    on the CPU): first + cumsum(unzigzag(unpack)) in u32 wrap, across
    mixed per-chunk widths, ragged tails and the zero-width chunk."""

    CHUNK = 16384

    @pytest.fixture(autouse=True)
    def _device_path(self, monkeypatch):
        from minnow_c_tpu.algos import chunked
        monkeypatch.setattr(chunked, "use_device", lambda x: True)

    def _build(self, widths_pattern, seed=0, trim=0):
        rng = np.random.default_rng(seed)
        n_chunks = len(widths_pattern)
        n = self.CHUNK * n_chunks - trim
        zz = np.zeros(n_chunks * self.CHUNK, np.uint32)
        for c, w in enumerate(widths_pattern):
            if w:
                zz[c * self.CHUNK:(c + 1) * self.CHUNK] = rng.integers(
                    0, 1 << w, self.CHUNK, dtype=np.int64)
        zz = zz[:n].copy()
        zz[0] = 0
        first = int(rng.integers(0, 1 << 31))
        zi = zz.astype(np.int64)
        d = ((zi >> 1) ^ -(zi & 1)).astype(np.int64)
        ref = (first + np.cumsum(d)) % (1 << 32)
        return zz, first, ref.astype(np.uint32), n

    def _payload(self, zz, first):
        """A Coil v1.1 plane payload with 16384-element chunks."""
        from minnow_c_tpu.algos import chunked
        from minnow_c_tpu.algos.algo_coil_v1_1 import _cmajor_blob
        zc, widths = chunked.chunk_widths(zz, self.CHUNK)
        body = _cmajor_blob(chunked.pack_chunks(zc, widths), widths,
                            self.CHUNK)
        head = np.array([len(widths), first], np.uint32).view(np.uint8)
        tag = np.array([14, 0, 0, 0], np.uint8)
        wtab = np.concatenate([widths,
                               np.zeros((-len(widths)) % 4, np.uint8)])
        return np.concatenate([head, tag, wtab, np.frombuffer(
            body, np.uint8)]).view(np.uint32), widths

    @pytest.mark.parametrize("pattern", [
        (7, 15, 7), (24,), (0, 9, 0, 3), (1, 32, 5)])
    def test_prefix_matches_cumsum(self, pattern):
        from minnow_c_tpu.algos.algo_coil_v1_1 import CoilV1_1
        zz, first, ref, n = self._build(pattern, trim=137)
        payload, _ = self._payload(zz, first)
        out = np.asarray(CoilV1_1()._decode_plane(payload, 0, n))
        np.testing.assert_array_equal(out, ref)

    def test_unpack_only(self):
        from minnow_c_tpu.algos import chunked
        zz, _, _, n = self._build((5, 11), trim=64)
        zc, widths = chunked.chunk_widths(zz, self.CHUNK)
        body = np.frombuffer(chunked.pack_chunks(zc, widths), np.uint32)
        out = np.asarray(chunked.unpack_chunks_device(body, widths,
                                                      self.CHUNK))
        np.testing.assert_array_equal(out.reshape(-1)[:n], zz)

    def test_cmajor_roundtrip(self):
        from minnow_c_tpu.algos import chunked
        rng = np.random.default_rng(3)
        for w in (1, 7, 32):
            nat = rng.integers(0, 1 << 32, self.CHUNK * w // 32,
                               dtype=np.int64).astype(np.uint32)
            cm = chunked.body_to_cmajor(nat, w, self.CHUNK)
            back = chunked.body_from_cmajor(cm, w, self.CHUNK)
            np.testing.assert_array_equal(back, nat)

    def test_rejects_bad_chunk_log2(self):
        from minnow_c_tpu.algos.algo_coil_v1_1 import CoilV1_1
        zz, first, _, n = self._build((4,))
        payload, _ = self._payload(zz, first)
        raw = payload.view(np.uint8).copy()
        raw[8] = 18
        with pytest.raises(ValueError, match="chunk_log2"):
            CoilV1_1()._decode_plane(raw.view(np.uint32), 0, n)


class TestRecipRows:
    """The batched writers' recip encode (anchored unwrap + block-shared
    rn(1/range) + rows pack) against the numpy recip map."""

    @pytest.mark.parametrize("periodic", [True, False])
    def test_matches_numpy_map(self, periodic):
        from minnow_c_tpu.parallel.sharding import (_float_rows_encode_recip,
                                                    _rows_stats_raw)
        B, D, n, depth = 3, 3, 2048, 14
        x = np.random.default_rng(1).uniform(0, W, (B, D, n)).astype(
            np.float32)
        box = W if periodic else None
        mn, mx = _rows_stats_raw(jnp.asarray(x.reshape(B * D, n)), box)
        mn = np.asarray(mn).reshape(B, D)
        rng_b = (np.asarray(mx).reshape(B, D) - mn).max(axis=1)
        words = np.asarray(_float_rows_encode_recip(
            jnp.asarray(x), jnp.asarray(mn), jnp.asarray(rng_b), depth,
            box))
        for b in range(B):
            recip = np.float32(1.0) / np.float32(rng_b[b])
            for d in range(D):
                bins = _recip_bins_np(x[b, d], mn[b, d], recip, box,
                                      x[b, d, 0], depth)
                np.testing.assert_array_equal(
                    words[b, d], native.uniform_pack_host(bins, depth))

    def test_constant_plane(self):
        from minnow_c_tpu.parallel.sharding import (_float_rows_encode_recip,
                                                    _rows_stats_raw)
        x = jnp.full((1, 3, 1024), 7.5, jnp.float32)
        mn, mx = _rows_stats_raw(x.reshape(3, -1), None)
        rng_b = jnp.max((mx - mn).reshape(1, 3), axis=1)
        words = np.asarray(_float_rows_encode_recip(
            x, mn.reshape(1, 3), rng_b, 11, None))
        np.testing.assert_array_equal(words, np.zeros_like(words))
        assert float(np.asarray(mn)[0]) == 7.5


class TestCoilFloats:
    """Coil v1.1's fused float decode (plane bins on the device path +
    the undo tail) against the oracle applied to the true bins."""

    @pytest.mark.parametrize("periodic", [True, False])
    def test_matches_oracle(self, periodic, monkeypatch):
        from minnow_c_tpu.algos import algo_coil_v1_1 as c11
        from minnow_c_tpu.algos import chunked
        monkeypatch.setattr(chunked, "use_device", lambda x: True)
        monkeypatch.setattr(c11, "BIG_PLANE", 16384)
        rng = np.random.default_rng(6)
        n, depth = 2 * 16384 + 513, 14
        walk = np.cumsum(rng.integers(-40, 41, n), dtype=np.int64)
        bins = ((walk - walk.min()) % (1 << depth)).astype(np.uint32)
        codec = c11.CoilV1_1()
        payload, _ = codec._encode_plane(jnp.asarray(bins), depth)
        key = np.asarray(_rng.field_key_arr(99, 1, 2))
        x0, dx = 0.25, 63.0
        got = np.asarray(c11._coil11_plane_floats(
            codec, payload, jnp.asarray(key), n, depth, x0, dx, W,
            periodic))
        want, mag = _decode_oracle(bins, key, depth, x0, dx,
                                   W if periodic else None)
        _assert_one_rounding(got, want, mag, W if periodic else None)
