#!/usr/bin/env python
"""Compression-ratio sweep: every codec x field type x ordering x accuracy
vs the reference pipeline's compressed size at parity settings.

The reference's only realized encoder is its mock fast-uniform pipeline
(bin at depth -> uniform pack -> LZ4, test/compress_util_bench.c:234-298);
util.c's primitives define its per-plane cost, plus the 4-byte raw-length
word its block headers must carry out-of-band (util.c:423-429).  For each
cell the table reports our full segment size (headers + checksums
included) against that reference size.

Wire bytes are backend-independent (encode is deterministic); this runs
on the CPU backend.  Writes ``doc/ratio_table.md`` + ``ratio_results.json``
and feeds doc/ratio_table.md (written below) and the test_ratio_sweep invariants.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import minnow_c_tpu as mnw  # noqa: E402
from minnow_c_tpu import semver as _sv  # noqa: E402
from minnow_c_tpu.ops import bitpack, entropy, kernels  # noqa: E402
from minnow_c_tpu.quant import engine as qe  # noqa: E402
from minnow_c_tpu.segment import api  # noqa: E402

W = 64.0
N = 200_000

CODECS = {
    "trim": (mnw.AlgoCode.TRIM, _sv.pack(1, 0, 0)),
    "diff": (mnw.AlgoCode.DIFF, _sv.pack(1, 0, 0)),
    "coil": (mnw.AlgoCode.COIL, _sv.pack(1, 0, 0)),
    "octo": (mnw.AlgoCode.OCTO, _sv.pack(1, 0, 0)),
    "sort": (mnw.AlgoCode.SORT, _sv.pack(1, 1, 0)),
    "cart": (mnw.AlgoCode.CART, _sv.pack(1, 0, 0)),
    # Sort v1.2 order-free profile (patch 1): drops the rank stream;
    # decode returns ascending values.  Single-plane fields only
    # ("n/a" cells elsewhere) -- Sort's niche: order-free scalar
    # archives (round-5 VERDICT item 9).
    "sort_of": (mnw.AlgoCode.SORT, _sv.pack(1, 2, 1)),
}

# Per-kind accuracy grids: each must satisfy delta * 2^24 > range (the
# f32 mantissa cap, quant.c:684-693) for its field's value range.
DELTAS = {
    "posn": [1e-2, 1e-3, 1e-4],   # range = box width 64
    "velc": [1.0, 1e-1, 1e-2],    # range ~2e3 for sigma=200 normals
    "unsf": [1e-2, 1e-3, 1e-4],   # range ~10
    "ptid": [0.0],                # lossless
    "unsi": [0.0],                # lossless raw u64 payload
}


def datasets(n=N, seed=0):
    """(field kind, ordering) -> data array."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.01, (3, n)).astype(np.float32)
    pos_coh = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    pos_rand = rng.uniform(0, W, (3, n)).astype(np.float32)
    vel_walk = np.cumsum(rng.normal(0, 2, (3, n)), axis=1).astype(
        np.float32)
    vel_rand = rng.normal(0, 200, (3, n)).astype(np.float32)
    uf_coh = np.cumsum(rng.normal(0, 0.01, n)).astype(np.float32) + 10.0
    uf_rand = rng.uniform(1, 10, n).astype(np.float32)
    ids_coh = (np.arange(n, dtype=np.uint64) +
               rng.integers(0, 3, n).astype(np.uint64))
    ids_rand = rng.permutation(1 << 24)[:n].astype(np.uint64)
    # dense permutation IDs archived as raw UNSI (single plane): the
    # order-free-archive workload where sorted deltas collapse to
    # ~1 bit/elem
    unsi_dense = rng.permutation(n).astype(np.uint64) + 7
    unsi_sparse = np.sort(rng.choice(1 << 30, n, replace=False)
                          ).astype(np.uint64)[rng.permutation(n)]
    return {
        ("posn", "coherent"): pos_coh,
        ("posn", "random"): pos_rand,
        ("velc", "coherent"): vel_walk,
        ("velc", "random"): vel_rand,
        ("unsf", "coherent"): uf_coh,
        ("unsf", "random"): uf_rand,
        ("ptid", "coherent"): ids_coh,
        ("ptid", "random"): ids_rand,
        ("unsi", "dense-perm"): unsi_dense,
        ("unsi", "sparse"): unsi_sparse,
    }


def ref_float_planes_size(planes: np.ndarray, delta: float) -> int:
    """Reference pipeline size for f32 planes (3, n) or (n,): shared-range
    bin at deltaToDepth -> uniform pack -> LZ4, + 4 B raw-length/plane."""
    p = planes.reshape(-1, planes.shape[-1])
    x0s = p.min(axis=1)
    dxs = float((p.max(axis=1) - x0s).max())
    depth = qe.delta_to_depth(delta, 0.0, dxs)
    total = 0
    for d in range(p.shape[0]):
        bins = kernels.uniform_bin_index(jnp.asarray(p[d]), depth,
                                         float(x0s[d]), np.float32(dxs))
        words = np.asarray(bitpack.uniform_pack(bins, depth))
        comp = entropy.encode(words)
        total += min(len(comp), words.nbytes) + 4
    return total


def ref_id_size(ids: np.ndarray, grid: int = 1024) -> int:
    """Reference pipeline size for Lagrangian IDs: grid decompose,
    min-subtract, pack at needed width, LZ4 (quant.c:291-327 + the mock
    pack/LZ4 stage)."""
    qdims, x0, x1 = qe.id_decompose(jnp.asarray(ids), grid)
    qd = np.asarray(qdims.astype(jnp.uint32))
    x1h = np.asarray(x1)
    x0h = np.asarray(x0)
    total = 0
    for d in range(3):
        width = max(1, int(x1h[d] - x0h[d]).bit_length())
        words = np.asarray(bitpack.uniform_pack(jnp.asarray(qd[d]), width))
        comp = entropy.encode(words)
        total += min(len(comp), words.nbytes) + 4
    return total


def ref_uint_size(vals: np.ndarray) -> int:
    """Reference pipeline size for raw u64 ints: min-subtract, pack at
    needed width, LZ4 (+4 B raw length) -- the uint branch of the mock
    pipeline (quant.c uint handling + compress_util_bench.c LZ4)."""
    lo = int(vals.min())
    rel = (vals - np.uint64(lo)).astype(np.uint64)
    width = max(1, int(rel.max()).bit_length())
    if width <= 32:
        words = np.asarray(bitpack.uniform_pack(
            jnp.asarray(rel.astype(np.uint32)), width))
    else:
        words = rel.view(np.uint32)
    comp = entropy.encode(np.ascontiguousarray(words))
    return min(len(comp), words.nbytes) + 4


def our_size(kind: str, data, delta: float, codec: str) -> int:
    algo, ver = CODECS[codec]
    n = data.shape[-1]
    if kind == "posn":
        acc = mnw.PositionAccuracy(delta=delta, width=W)
        fc = mnw.FieldCode.POSN
    elif kind == "velc":
        acc = mnw.VelocityAccuracy(delta=delta)
        fc = mnw.FieldCode.VELC
    elif kind == "unsf":
        acc = mnw.FloatAccuracy(delta=delta)
        fc = mnw.FieldCode.UNSF
    elif kind == "unsi":
        acc = mnw.IntAccuracy()
        fc = mnw.FieldCode.UNSI
    else:
        acc = mnw.IDAccuracy(width=1024)
        fc = mnw.FieldCode.PTID
    seg = mnw.Seg(fields=[mnw.Field(
        hd=mnw.FieldHeader(fc, algo, ver, n), data=data, acc=acc)])
    return len(api.compress_segment(seg, seed=1))


def main():
    from minnow_c_tpu.utils import compile_cache
    compile_cache.enable()
    data = datasets()
    rows = []
    for (kind, order), arr in data.items():
        for delta in DELTAS[kind]:
            if kind == "ptid":
                ref = ref_id_size(arr)
            elif kind == "unsi":
                ref = ref_uint_size(arr)
            else:
                ref = ref_float_planes_size(arr, delta)
            cells = {}
            for codec in CODECS:
                if codec == "sort_of" and kind not in ("unsf", "unsi"):
                    cells[codec] = "n/a"  # single-plane profile only
                    continue
                try:
                    cells[codec] = our_size(kind, arr, delta, codec)
                except Exception as e:  # pragma: no cover
                    cells[codec] = f"err: {e!r}"[:60]
            raw = arr.nbytes
            rows.append({"field": kind, "order": order, "delta": delta,
                         "raw": raw, "ref": ref, **cells})
            # the parity verdict compares ORDER-PRESERVING codecs only:
            # sort_of surrenders element order (a different contract)
            ints = [v for c, v in cells.items()
                    if isinstance(v, int) and c != "sort_of"]
            best = min(ints) if ints else None  # all codecs errored
            verdict = "ERR" if best is None else (
                "OK" if best <= ref + 512 else "OVER")
            print(f"{kind}/{order} d={delta:g}: ref={ref} "
                  f"trim={cells['trim']} best={best} ({verdict})",
                  flush=True)

    with open("ratio_results.json", "w") as f:
        json.dump(rows, f, indent=1)

    hdr = ["field", "order", "delta", "raw", "ref"] + list(CODECS)
    lines = [
        "# Compression-ratio sweep vs reference pipeline",
        "",
        f"n = {N:,} particles per cell; sizes in bytes.  `ref` = the",
        "reference's fast-uniform pipeline (bin -> pack -> LZ4 + 4 B/plane",
        "raw-length, test/compress_util_bench.c:234-298) at identical",
        "accuracy; codec columns are full self-describing segments",
        "(headers + checksums included).  Invariant (tested in",
        "tests/test_ratio_sweep.py): trim <= ref + 512 B fixed header",
        "overhead on every row, and the best codec beats ref outright on",
        "coherent orderings.",
        "",
        "`sort_of` = Sort v1.2 order-free profile (version 1.2.1): the",
        "rank stream is dropped and values decode in ASCENDING order --",
        "lossless VALUES, surrendered ORDER, single-plane fields only",
        "('n/a' elsewhere).  It is excluded from the order-preserving",
        "parity verdict but is the outright best choice for order-free",
        "scalar archives (the unsi rows).",
        "",
        "| " + " | ".join(hdr) + " |",
        "|" + "---|" * len(hdr),
    ]
    for r in rows:
        lines.append("| " + " | ".join(str(r[k]) for k in hdr) + " |")
    os.makedirs("doc", exist_ok=True)
    with open("doc/ratio_table.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote ratio_results.json, doc/ratio_table.md")


if __name__ == "__main__":
    main()
