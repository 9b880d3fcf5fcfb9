#!/usr/bin/env python
"""Benchmark matrix over the BASELINE.json configs, on the GPU.

    python bench_all.py [config1 config2 ...]

Writes ``bench_results.json`` (merge-safe: only the configs run are
replaced).  Every record carries the device it ran on; the run refuses to
start without a GPU.  The headline metric lives in ``bench.py``.

1. 1M-value single-segment round trip (correctness oracle config)
2. 25.2M positions: the single-stream quantize+bin+pack encode
3. 10M-particle pos+vel+ids through the snapshot writer and reader
4. positions sharded as 8 blocks: device round trip, D2H gather, host LZ4
   (``config4``), and the 100M-particle single pass (``config4_100m``)
5. the SPMD dry run on an 8-device virtual CPU mesh and the two-process
   jax.distributed test (a child process, off the card)
6. streaming snapshot writer: 6 waves of 4M particles, flat host memory
"""

import io
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from minnow_c_tpu.bench import harness  # noqa: E402

results = {}
W = 64.0


def log(msg):
    print(msg, flush=True)


def config1():
    import minnow_c_tpu as mnw
    from minnow_c_tpu.algos import registry
    from minnow_c_tpu.segment import api

    n = 1_000_000
    pos = np.random.default_rng(0).uniform(0, W, (3, n)).astype(np.float32)
    ver = registry.newest(mnw.AlgoCode.TRIM)

    def make(p):
        return mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.POSN, mnw.AlgoCode.TRIM, ver,
                               n),
            data=p, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])

    # warm: compilation is set-up, not throughput
    api.decompress_segment(api.compress_segment(make(pos), seed=0),
                           fused=True)
    t0 = time.perf_counter()
    blob = api.compress_segment(make(pos), seed=1)
    t1 = time.perf_counter()
    out = np.asarray(api.decompress_segment(blob, fused=True).fields[0].data)
    t2 = time.perf_counter()
    err = np.abs(out - pos)
    ok = bool((np.minimum(err, W - err) <= 1e-3).all())
    results["config1_1M_roundtrip"] = {
        "within_delta": ok, "encode_s": t1 - t0, "decode_s": t2 - t1,
        "ratio": len(blob) / pos.nbytes, "note": "warm; fused decode"}
    log(f"config1: ok={ok} enc={t1 - t0:.3f}s dec={t2 - t1:.3f}s")


def config2():
    from minnow_c_tpu.ops import bitpack, fastpath, kernels

    n, depth = (1 << 14) * 1536, 14  # 25.2M values, ~100 MB
    x = jax.device_put(jnp.asarray(
        np.random.default_rng(1).uniform(0, W, n).astype(np.float32)))

    def encoder(mode):
        # the salt perturbs the box width below f32 resolution
        # (W * (1 + s*1e-45) == W), so every call's inputs are distinct
        # while the work is unchanged
        @jax.jit
        def enc(xin, salt):
            box = jnp.float32(W) * (jnp.float32(1.0) +
                                    salt.astype(jnp.float32) *
                                    jnp.float32(1e-45))
            w, _, _ = fastpath.fast_uniform_encode(
                xin, depth, periodic_width=box, scale_mode=mode)
            return w
        return enc

    res = harness.run(lambda s, f=encoder("div"): f(x, s), n * 4)
    res_r = harness.run(lambda s, f=encoder("recip"): f(x, s), n * 4)
    bins = jax.block_until_ready(jax.jit(
        lambda xx: kernels.uniform_bin_index(
            xx, depth, jnp.min(xx), jnp.max(xx) - jnp.min(xx)))(x))
    pack = jax.jit(lambda b, s: bitpack.uniform_pack(b ^ (s & 1), depth))
    res_p = harness.run(lambda s: pack(bins, s), n * 4)
    results["config2_encode_kernel"] = {
        "GBps": res.gb_per_second, "recip_mode_GBps": res_r.gb_per_second,
        "pack_only_GBps": res_p.gb_per_second, "depth": depth,
        "input_MB": n * 4 / 1e6,
        "note": "GB/s of f32 input; pack_only includes the salt XOR pass"}
    log(f"config2: encode {res.gb_per_second:.2f} GB/s, recip "
        f"{res_r.gb_per_second:.2f} GB/s, pack {res_p.gb_per_second:.2f} "
        "GB/s")


def config3():
    import minnow_c_tpu as mnw
    from minnow_c_tpu.parallel import snapshot

    n = 10_000_000
    rng = np.random.default_rng(2)
    steps = rng.normal(0, 0.01, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 24)[:n].astype(np.uint64)
    raw = pos.nbytes + vel.nbytes + ids.nbytes
    spec = snapshot.SnapshotSpec(
        pos=mnw.PositionAccuracy(delta=1e-3, width=W),
        vel=mnw.VelocityAccuracy(delta=1.0), ids=mnw.IDAccuracy(width=1024))

    def roundtrip(seed):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        stats = snapshot.compress_snapshot(buf, pos, vel, ids, spec,
                                           num_blocks=8, seed=seed)
        t1 = time.perf_counter()
        buf.seek(0)
        out = snapshot.decompress_snapshot(buf)
        return stats, out, t1 - t0, time.perf_counter() - t1

    roundtrip(0)  # warm
    stats, out, t_enc, t_dec = roundtrip(1)
    err = np.abs(out["pos"] - pos)
    ok = bool((np.minimum(err, W - err) <= 1e-3).all() and
              (out["ids"] == ids).all())
    results["config3_10M_multifield"] = {
        "ok": ok, "encode_s": t_enc, "decode_s": t_dec,
        "ratio": stats["bytes"] / raw, "note": "warm, end to end"}
    log(f"config3: ok={ok} enc={t_enc:.2f}s dec={t_dec:.2f}s")


def _position_codec(**kw):
    from minnow_c_tpu.parallel.sharding import (ShardedPositionCodec,
                                                make_mesh, spmd_depth_for)
    return ShardedPositionCodec(mesh=make_mesh(), width=W,
                                depth=spmd_depth_for(1e-3, W), **kw)


def config4_100m():
    """100M particles (8 blocks of 12,582,912), single pass on one card;
    encode and decode timed separately, error over the full output."""
    B, nb = 8, 12_582_912
    n = B * nb
    codec = _position_codec()
    xd = jax.device_put(jnp.asarray(np.random.default_rng(7).uniform(
        0, W, (B * 3, nb)).astype(np.float32)), codec._in_shardings())
    enc = codec.encode(xd)
    out = codec.decode(*enc, seed=4)
    e = jnp.abs(out - xd)
    err = float(jnp.max(jnp.minimum(e, W - e)))
    del out, e
    seed_arr = jnp.asarray([4], dtype=jnp.uint32)
    zero_blk = jnp.zeros((1,), jnp.int32)

    def salted_encode(c):
        # the salt replaces one input value, so every call's inputs differ
        return jax.jit(lambda xin, s: c._encode(xin.at[0, 0].set(
            jax.lax.bitcast_convert_type(s & 0x3FFFFF, jnp.float32)))[0])

    dec_salted = jax.jit(lambda words, s: codec._decode(
        words ^ s, *enc[1:], seed_arr, zero_blk))
    enc_div = salted_encode(codec)
    enc_recip = salted_encode(_position_codec(scale_mode="recip"))
    res_e = harness.run(lambda s: enc_div(xd, s), n * 12)
    res_er = harness.run(lambda s: enc_recip(xd, s), n * 12)
    res_d = harness.run(lambda s: dec_salted(enc[0], s), n * 12)
    results["config4_100M_single_pass"] = {
        "particles": n, "blocks": B, "depth": codec.depth,
        "encode_GBps": res_e.gb_per_second,
        "encode_recip_GBps": res_er.gb_per_second,
        "decode_GBps": res_d.gb_per_second, "max_err_full_array": err,
        "within_delta": bool(err <= 1e-3),
        "note": "GB/s of 12 B/particle raw positions; D2H excluded"}
    log(f"config4_100M: encode {res_e.gb_per_second:.1f} GB/s, recip "
        f"{res_er.gb_per_second:.1f}, decode {res_d.gb_per_second:.1f}")


def config4():
    from minnow_c_tpu.ops import entropy

    B, nb = 8, 6_249_984
    n = B * nb
    codec = _position_codec()
    xd = jax.device_put(jnp.asarray(np.random.default_rng(3).uniform(
        0, W, (B * 3, nb)).astype(np.float32)))
    seed_arr = jnp.asarray([4], dtype=jnp.uint32)
    zero_blk = jnp.zeros((1,), jnp.int32)

    @jax.jit
    def roundtrip(xin, s):
        words, x0b, rng_b = codec._encode(xin.at[0, 0].set(
            jax.lax.bitcast_convert_type(s & 0x3FFFFF, jnp.float32)))
        return codec._decode(words, x0b, rng_b, seed_arr, zero_blk)

    res = harness.run(lambda s: roundtrip(xd, s), n * 12)
    words, x0b, rng_b = codec.encode(xd)
    out = codec.decode(words, x0b, rng_b, seed=4)
    jax.block_until_ready(out)
    tg0 = time.perf_counter()
    words_h = np.asarray(words).reshape(B, 3, -1)
    tg1 = time.perf_counter()
    blobs = entropy.encode_blocks(
        [np.ascontiguousarray(words_h[b, i]) for b in range(B)
         for i in range(3)])
    tg2 = time.perf_counter()
    e = jnp.abs(out - xd)
    err = float(jnp.max(jnp.minimum(e, W - e)))
    results["config4_sharded_blocks"] = {
        "particles": n, "blocks": B,
        "device_roundtrip_GBps": res.gb_per_second,
        "gather_D2H_s": tg1 - tg0, "host_lz4_s": tg2 - tg1,
        "max_err_full_array": err, "within_delta": bool(err <= 1e-3),
        "packed_ratio": sum(len(b) for b in blobs) / (n * 12)}
    log(f"config4: device round trip {res.gb_per_second:.2f} GB/s, D2H "
        f"{tg1 - tg0:.2f}s, LZ4 {tg2 - tg1:.2f}s")


def config6_streaming():
    """Stream 6 waves of 4M positions through the writer; host memory must
    stay flat (independent of the total snapshot size)."""
    import resource

    import minnow_c_tpu as mnw
    from minnow_c_tpu.parallel import snapshot

    nb, waves = 4_000_000, 6
    rng = np.random.default_rng(11)
    spec = snapshot.SnapshotSpec(pos=mnw.PositionAccuracy(delta=1e-3,
                                                          width=W))
    rss = []
    wave_s = []

    def blocks():
        for _ in range(waves):
            pos = rng.uniform(0, W, (3, nb)).astype(np.float32)
            t0 = time.perf_counter()
            yield {"pos": pos}
            wave_s.append(time.perf_counter() - t0)
            rss.append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)

    t0 = time.perf_counter()
    with tempfile.TemporaryFile() as f:
        stats = snapshot.compress_snapshot_streaming(
            f, blocks(), spec, seed=3, depths={"pos": 17})
    wall = time.perf_counter() - t0
    growth_mb = (rss[-1] - rss[0]) / 1024
    results["config6_streaming"] = {
        "particles": nb * waves, "wave_particles": nb, "waves": waves,
        "bytes": stats["bytes"], "wall_s": wall,
        "wave_s_after_warm": float(np.median(wave_s[1:])),
        "rss_growth_after_wave1_MB": growth_mb}
    log(f"config6: {nb * waves / 1e6:.0f}M streamed, wall {wall:.1f}s, "
        f"RSS growth {growth_mb:.0f} MB")


def config5():
    """SPMD semantics on an 8-device virtual CPU mesh: a child process
    pinned to the CPU, so it never competes with this process for the
    card."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        capture_output=True, text=True, timeout=900, cwd=here, env=env)
    ok = "OK" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_multihost.py", "-q"],
        capture_output=True, text=True, timeout=900, cwd=here, env=env)
    results["config5_multichip_dryrun"] = {
        "dryrun_8way_mesh": ok, "two_process_spmd": r2.returncode == 0,
        "note": "virtual CPU devices; no scaling number"}
    log(f"config5: dry run ok={ok} two-process ok={r2.returncode == 0}")
    if not ok:
        log(r.stderr[-2000:])


def main():
    harness.require_gpu()
    from minnow_c_tpu.bench import records
    from minnow_c_tpu.utils import compile_cache
    compile_cache.enable()
    selected = set(sys.argv[1:])
    fns = [f for f in (config1, config2, config3, config4, config4_100m,
                       config5, config6_streaming)
           if not selected or f.__name__ in selected]
    device = harness.device_record()
    for fn in fns:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - keep the matrix running
            results[fn.__name__] = {"error": repr(e)[:500]}
            log(f"{fn.__name__} FAILED: {e!r}")
    for rec in results.values():
        rec.update(device)
    records.update_sections("bench_results.json", results)
    log("wrote bench_results.json")


if __name__ == "__main__":
    main()
