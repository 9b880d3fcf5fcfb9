#!/usr/bin/env python
"""Headline benchmark: decode throughput of the fast-uniform path on one
GPU.

Workload mirrors the reference's "(mock) undo fast compress" bench
(test/compress_util_bench.c:264-298): unpack packed bins -> dithered
undo-bin-index -> periodic rewrap, at level 11, on a 100 MB f32 stream.
Throughput is GB/s of decoded f32 output.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "platform": ...,
   "device_kind": ..., "device_count": N, "card": "<name>, <power limit>"}
and refuses to run without a GPU.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from minnow_c_tpu.bench import harness  # noqa: E402
from minnow_c_tpu.ops import fastpath, native  # noqa: E402
from minnow_c_tpu.ops import rng as _rng  # noqa: E402

LEVEL = 11  # reference bench uses level 11 (compress_util_bench.c:247)
N = 25_165_824  # ~100 MB of f32 output (compress_util_bench.c:318)
WIDTH_BOX = 64.0


def main():
    harness.require_gpu()
    from minnow_c_tpu.utils import compile_cache
    compile_cache.enable()
    bins = np.random.default_rng(0).integers(
        0, 1 << LEVEL, N, dtype=np.uint64).astype(np.uint32)
    packed = jax.device_put(jnp.asarray(native.uniform_pack_host(bins,
                                                                 LEVEL)))
    key = _rng.field_key_arr(1234, 0, 0)

    @jax.jit
    def decode(words, salt):
        return fastpath.fast_uniform_decode(
            words, key ^ salt, LEVEL, N, 0.0, WIDTH_BOX,
            periodic_width=WIDTH_BOX)

    res = harness.run(lambda s: decode(packed, s), bytes_per_iter=N * 4)
    print(json.dumps({"metric": "decode_fast_uniform_GBps",
                      "value": res.gb_per_second, "unit": "GB/s",
                      **harness.device_record()}), flush=True)


if __name__ == "__main__":
    main()
