#!/usr/bin/env python
"""Per-operation device times of the codec's XLA paths, each beside a
plain device-to-device copy of the same bytes.

    python bench_kernels.py [--grid 512] [--seed 0]

Operations run at the shapes of the snapshot ``chip_smoke.py`` writes
(a displaced 512^3 lattice in 16 blocks of 2^23 particles): positions
(17-bit bins), velocities (12-bit) and ID grid coordinates, through the
same functions the snapshot writer and reader call, plus the delta-family
pieces on one 2^23-element plane.  For each operation the line gives the
time per call (median of 5 timed windows of 3 calls, after a warm-up
call that compiles), the bytes it must move (inputs + outputs), the rate
that implies and its share of the copy's rate.  Host-side work inside an
operation (the chunked codecs' table handling) is part of its time.

Writes ``bench_kernels.json`` beside this script (the ``meta`` and
``results`` sections; other sections are kept) and refuses to run
without a GPU.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from minnow_c_tpu.bench import harness  # noqa: E402

results = {}


def dump_results(meta=None):
    """Write ``bench_kernels.json`` (merge-safe: only ``meta`` and
    ``results`` are replaced)."""
    from minnow_c_tpu.bench import records
    out = {"meta": dict(meta or {}, **harness.device_record(),
                        timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime())),
           "results": results}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_kernels.json")
    records.update_sections(path, out)
    print(json.dumps(out))


def time_call(fn, *args, windows: int = 5, calls: int = 3) -> float:
    """Seconds per call: median over ``windows`` of ``calls`` back-to-back
    calls, each window ending in block_until_ready."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / calls)
    return statistics.median(ts)


def nbytes(*arrays) -> int:
    return sum(int(np.prod(a.shape)) * a.dtype.itemsize
               for a in jax.tree.leaves(arrays))


def pack_rows_sum(x, width: int):
    """Candidate for ``bitpack.uniform_pack_rows``: the same fold with a
    masked sum over the 32-element axis in place of the u32 matrix
    product (disjoint bits, so the sum is an OR)."""
    rows, n = x.shape
    vals = x.reshape(rows * (n // 32), 32) & jnp.uint32((1 << width) - 1)
    k = np.arange(32)
    lsh = ((k * width) % 32).astype(np.uint32)
    tgt = (k * width) // 32
    straddle = (lsh + width) > 32
    lo = vals << jnp.asarray(lsh)[None, :]
    rsh = np.where(straddle, 32 - lsh, 0).astype(np.uint32)
    hi = jnp.where(jnp.asarray(straddle)[None, :],
                   vals >> jnp.asarray(rsh)[None, :], jnp.uint32(0))
    j = np.arange(width)
    sel_lo = jnp.asarray(tgt[:, None] == j[None, :])
    sel_hi = jnp.asarray((tgt[:, None] + 1 == j[None, :]) & straddle[:, None])
    zero = jnp.uint32(0)
    words = (jnp.sum(jnp.where(sel_lo[None], lo[:, :, None], zero), axis=1,
                     dtype=jnp.uint32) +
             jnp.sum(jnp.where(sel_hi[None], hi[:, :, None], zero), axis=1,
                     dtype=jnp.uint32))
    return words.reshape(rows, (n // 32) * width)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grid", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    harness.require_gpu()
    from minnow_c_tpu.utils import compile_cache
    compile_cache.enable()

    import chip_smoke
    from minnow_c_tpu.algos import chunked
    from minnow_c_tpu.algos.algo_coil_v1_1 import CoilV1_1
    from minnow_c_tpu.ops import bitpack, kernels
    from minnow_c_tpu.ops import rng as _rng
    from minnow_c_tpu.parallel import snapshot
    from minnow_c_tpu.quant import engine

    tag = harness.card_tag()
    B = 16
    box = chip_smoke.BOX
    pos, vel, ids = chip_smoke.make_snapshot(args.grid, args.seed)
    n = ids.shape[0]
    nb = n // B
    xb = jax.device_put(np.ascontiguousarray(
        np.moveaxis(pos.reshape(3, B, nb), 1, 0)))
    vb = jax.device_put(np.ascontiguousarray(
        np.moveaxis(vel.reshape(3, B, nb), 1, 0)))

    def report(name, seconds, moved):
        copy_rate = results.get("copy", {}).get("GBps")
        rate = moved / seconds / 1e9
        results[name] = {"ms": seconds * 1e3, "bytes": moved, "GBps": rate,
                         "share_of_copy": (rate / copy_rate
                                           if copy_rate else 1.0)}
        print(f"{name:28s} {seconds * 1e3:10.3f} ms {moved / 1e9:8.3f} GB "
              f"{rate:9.1f} GB/s  {results[name]['share_of_copy']:6.3f} "
              f"of copy | {tag}", flush=True)

    def op(name, fn, *a):
        out = fn(*a)
        report(name, time_call(fn, *a), nbytes(a) + nbytes(out))
        return out

    words_in = jax.device_put(jnp.arange(B * 3 * nb, dtype=jnp.uint32)
                              .reshape(B * 3, nb))
    op("copy", jax.jit(lambda x: x ^ jnp.uint32(1)), words_in)
    del words_in

    # positions: stats -> bin -> pack (the writer), unpack -> undo (reader)
    x0, rng_b = op("pos.stats", lambda x: snapshot._batched_stats_pos(
        x, box), xb)
    pdepth = engine.delta_to_depth(chip_smoke.POS_DELTA, 0.0,
                                   float(np.asarray(jnp.max(rng_b))))
    words = op("pos.bin+pack", lambda x, a, r: snapshot._batched_bin_pack_pos(
        x, a, r, pdepth, box), xb, x0, rng_b)
    bins = op("pos.bin", jax.jit(lambda x, a, r: jax.vmap(
        lambda xb_, ab, rb: jax.vmap(lambda xd, o: kernels.uniform_bin_index(
            kernels.undo_periodic(xd, box), pdepth, o, rb))(xb_, ab))(
        x, a, r)), xb, x0, rng_b)
    bins_rows = bins.reshape(B * 3, nb)
    packed = op(f"pack_rows.{pdepth}", lambda b: bitpack.uniform_pack_rows(
        b, pdepth), bins_rows)
    alt = op(f"pack_rows_sum.{pdepth}", jax.jit(
        lambda b: pack_rows_sum(b, pdepth)), bins_rows)
    results[f"pack_rows_sum.{pdepth}"]["equal"] = bool(
        jnp.array_equal(packed, alt))
    del packed, alt
    del bins, bins_rows
    key = jnp.asarray(_rng.field_key(args.seed, 0, 0), jnp.uint32)
    op("pos.decode(1 dim)", lambda w, a, r: snapshot._batched_float_decode(
        w, a, r, key, pdepth, nb, True, jnp.float32(box)),
        words[:, :1], x0[:, :1], rng_b)
    w2 = words[:, 0]
    op(f"unpack.{pdepth}", jax.jit(jax.vmap(
        lambda r: bitpack.uniform_unpack(r, pdepth, nb))), w2)
    op(f"unpack_gather.{pdepth}", jax.jit(jax.vmap(
        lambda r: bitpack.uniform_unpack_gather(r, pdepth, nb))), w2)
    del words, w2

    # velocities
    vx0, vrng = op("vel.stats", lambda v: snapshot._batched_stats_vel(v),
                   vb)
    vdepth = engine.delta_to_depth(chip_smoke.VEL_DELTA, 0.0,
                                   float(np.asarray(jnp.max(vrng))))
    vwords = op("vel.bin+pack", lambda v, a, r: snapshot._batched_bin_pack_vel(
        v, a, r, vdepth), vb, vx0, vrng)
    op("vel.decode(1 dim)", lambda w, a, r: snapshot._batched_float_decode(
        w, a, r, key, vdepth, nb, False, jnp.float32(0.0)),
        vwords[:, :1], vx0[:, :1], vrng.astype(jnp.float32))
    del vwords, xb, vb

    # IDs: device decompose, then the per-dim rows pack
    ids_d = jax.device_put(ids)
    qdims = op("ids.decompose", lambda i: engine.id_decompose(
        i, args.grid)[0], ids_d)
    rel = qdims.astype(jnp.uint32).reshape(3, B, nb)[0]
    iw = max(1, int(np.asarray(jnp.max(rel))).bit_length())
    op(f"ids.pack_rows.{iw}", lambda r: snapshot._batched_id_pack(r, iw),
       rel)
    del ids_d, qdims, rel

    # delta family on one plane of 2^23 positions (Coil v1.1 layout)
    plane = jnp.asarray(pos[0, :nb])
    lo, hi = jnp.min(plane), jnp.max(plane)
    pbins = kernels.uniform_bin_index(plane, pdepth, lo, hi - lo)
    coil = CoilV1_1()
    payload, _ = coil._encode_plane(pbins, pdepth)
    t_enc = time_call(lambda b: coil._encode_plane(b, pdepth)[0], pbins,
                      windows=3, calls=1)
    report("coil.encode_plane", t_enc, nb * 4 + payload.nbytes)
    t_dec = time_call(lambda w: coil._decode_plane(w, 0, nb), payload,
                      windows=3, calls=1)
    report("coil.decode_plane", t_dec, payload.nbytes + nb * 4)
    z = kernels.u32_delta_zigzag(pbins)
    op("cumsum_u32", jax.jit(lambda v: jnp.cumsum(v).astype(jnp.uint32)), z)
    zc, widths = chunked.chunk_widths_device(z, 16384)
    body = np.frombuffer(chunked.pack_chunks_device(zc, widths), np.uint32)
    t_unp = time_call(lambda b: chunked.unpack_chunks_device(
        b, widths, 16384), body, windows=3, calls=1)
    report(f"chunked.unpack({len(np.unique(widths))} widths)", t_unp,
           body.nbytes + nb * 4)

    dump_results({"grid": args.grid, "blocks": B, "pos_depth": pdepth,
                  "vel_depth": vdepth, "id_width": iw})


if __name__ == "__main__":
    main()
