#!/usr/bin/env python
"""Per-codec encode/decode throughput on the GPU: all six spec'd
algorithms at 25M values (~100 MB), coherent and random inputs.

Measures warm end-to-end wall time through the public segment API
(``compress_segment`` / ``decompress_segment(fused=True)``): device
work + host orchestration + LZ4 + (de)serialization -- what a user
actually gets per segment.  Decoded outputs stay on device and are
waited for with ``block_until_ready``.

Updates the "codecs" section of bench_kernels.json; refuses to run
without a GPU.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import minnow_c_tpu as mnw  # noqa: E402
from minnow_c_tpu import semver  # noqa: E402
from minnow_c_tpu.bench import harness  # noqa: E402
from minnow_c_tpu.segment import api  # noqa: E402

N = 25_165_824  # 3 x 8,388,608 values = 100.66 MB f32
W = 64.0

ALGOS = [
    ("trim", mnw.AlgoCode.TRIM, semver.pack(1, 0, 0)),
    ("diff", mnw.AlgoCode.DIFF, semver.pack(1, 0, 0)),
    ("coil", mnw.AlgoCode.COIL, semver.pack(1, 1, 0)),
    ("octo", mnw.AlgoCode.OCTO, semver.pack(1, 1, 0)),
    ("sort", mnw.AlgoCode.SORT, semver.pack(1, 2, 0)),
    ("cart", mnw.AlgoCode.CART, semver.pack(1, 0, 0)),
]


def make_inputs():
    n = N // 3
    rng = np.random.default_rng(7)
    steps = rng.normal(0, 0.003, (3, n)).astype(np.float32)
    coherent = ((np.cumsum(steps, axis=1) + W / 2) % W).astype(np.float32)
    random = rng.uniform(0, W, (3, n)).astype(np.float32)
    return {"coherent": coherent, "random": random}


def fetch_barrier(seg):
    """Wait for the decoded field's device work."""
    jax.block_until_ready(seg.fields[0].data)
    return seg


def _cache_programs() -> int:
    """Entries in the persistent compile cache (warm-up cost grows with
    the programs a codec compiles)."""
    from minnow_c_tpu.utils import compile_cache
    try:
        return len(os.listdir(compile_cache.cache_dir()))
    except OSError:
        return 0


def main():
    harness.require_gpu()
    from minnow_c_tpu.utils import compile_cache
    compile_cache.enable()
    results = {}
    inputs = make_inputs()
    raw = N * 4
    for name, algo, ver in ALGOS:
        for kind, pos in inputs.items():
            seg = mnw.Seg(fields=[mnw.Field(
                hd=mnw.FieldHeader(mnw.FieldCode.POSN, algo, ver,
                                   pos.shape[1]),
                data=pos, acc=mnw.PositionAccuracy(delta=1e-3, width=W))])
            progs0 = _cache_programs()
            t0 = time.perf_counter()
            blob = api.compress_segment(seg, seed=3)   # warm (compiles)
            warm_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = api.decompress_segment(blob, fused=True)
            fetch_barrier(out)
            warm_dec = time.perf_counter() - t0
            progs = _cache_programs() - progs0

            REPS = 3
            enc_s = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                blob = api.compress_segment(seg, seed=3)
                enc_s.append(time.perf_counter() - t0)
            dec_s = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                out = api.decompress_segment(blob, fused=True)
                fetch_barrier(out)
                dec_s.append(time.perf_counter() - t0)
            enc = sorted(enc_s)[REPS // 2]
            dec = sorted(dec_s)[REPS // 2]
            results[f"{name}_{kind}"] = {
                "encode_s": round(enc, 3),
                "decode_s": round(dec, 3),
                "encode_GBps": round(raw / enc / 1e9, 2),
                "decode_GBps": round(raw / dec / 1e9, 2),
                "ratio": round(len(blob) / raw, 4),
                "warm_enc_s": round(warm_enc, 1),
                "warm_dec_s": round(warm_dec, 1),
                "programs_compiled": progs,
            }
            print(f"{name:>5} {kind:>8}: enc {raw/enc/1e9:6.2f} GB/s  "
                  f"dec {raw/dec/1e9:6.2f} GB/s  "
                  f"ratio {len(blob)/raw:.3f}", flush=True)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_kernels.json")
    from minnow_c_tpu.bench import records
    codecs = records.load(path).get("codecs", {})
    codecs.update({
        "meta": {
            "workload": f"POSN field, {N} f32 values (~100 MB), "
                        "delta=1e-3, warm end-to-end wall via "
                        "compress_segment/decompress_segment(fused) "
                        "incl. host LZ4 + (de)serialization; decoded "
                        "output device-resident",
            **harness.device_record(),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        },
        "results": results,
    })
    records.update_sections(path, {"codecs": codecs})
    print("updated bench_kernels.json [codecs]", flush=True)


if __name__ == "__main__":
    main()
