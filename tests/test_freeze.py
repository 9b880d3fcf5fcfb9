"""Wire-freeze tests: frozen algorithm versions must produce byte-identical
streams forever (header_format.tex:239-283).  These fixtures pin the v1.0
wire behavior of every codec; if any test here fails, either revert the
change or move it into a new minor version module.

The fixtures are self-generating: on first run (or after `rm`), the
expected digests are written to tests/fixtures/wire_digests.json; CI runs
compare against the committed file.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import minnow_c_tpu as mnw
from minnow_c_tpu.algos import registry
from minnow_c_tpu.segment import api

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "wire_digests.json")

from minnow_c_tpu import semver as _sv

# name -> (algo code, pinned packed version).  "sort" keeps naming the 1.0
# stream (fixture written before 1.1 existed); new versions get new keys.
ALGOS = {
    "trim": (mnw.AlgoCode.TRIM, _sv.pack(1, 0, 0)),
    "diff": (mnw.AlgoCode.DIFF, _sv.pack(1, 0, 0)),
    "coil": (mnw.AlgoCode.COIL, _sv.pack(1, 0, 0)),
    "octo": (mnw.AlgoCode.OCTO, _sv.pack(1, 0, 0)),
    "sort": (mnw.AlgoCode.SORT, _sv.pack(1, 0, 0)),
    "sort_v1_1": (mnw.AlgoCode.SORT, _sv.pack(1, 1, 0)),
    "trim_v1_1": (mnw.AlgoCode.TRIM, _sv.pack(1, 1, 0)),
    "coil_v1_1": (mnw.AlgoCode.COIL, _sv.pack(1, 1, 0)),
    "sort_v1_2": (mnw.AlgoCode.SORT, _sv.pack(1, 2, 0)),
    "octo_v1_1": (mnw.AlgoCode.OCTO, _sv.pack(1, 1, 0)),
    "cart": (mnw.AlgoCode.CART, _sv.pack(1, 0, 0)),
}


def reference_segment(algo, ver):
    """A deterministic segment exercising every field type."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(12345)
    steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
    uf = rng.uniform(1, 10, n).astype(np.float32)
    ui = (rng.integers(0, 1000, n) + 5_000_000).astype(np.uint64)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    return mnw.Seg(fields=[
        mnw.Field(hd=hd(mnw.FieldCode.POSN), data=pos,
                  acc=mnw.PositionAccuracy(delta=1e-3, width=W)),
        mnw.Field(hd=hd(mnw.FieldCode.VELC), data=vel,
                  acc=mnw.VelocityAccuracy(delta=0.25)),
        mnw.Field(hd=hd(mnw.FieldCode.PTID), data=ids,
                  acc=mnw.IDAccuracy(width=512)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSF), data=uf,
                  acc=mnw.FloatAccuracy(delta=1e-3)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSI), data=ui,
                  acc=mnw.IntAccuracy()),
    ])


def deltas_segment(algo, ver):
    """Per-particle-depth (Deltas mode) segment: pins the variable-width
    wire AND the C-exact 2^depth arithmetic (XLA's exp2 is approximate at
    integer inputs and must never leak into this path)."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(54321)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    uf = rng.uniform(1, 9, n).astype(np.float32)
    deltas = rng.choice(
        np.array([1e-1, 1e-2, 1e-3], dtype=np.float32), n)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    return mnw.Seg(fields=[
        mnw.Field(hd=hd(mnw.FieldCode.POSN), data=pos,
                  acc=mnw.PositionAccuracy(delta=0.0, width=W,
                                           deltas=deltas)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSF), data=uf,
                  acc=mnw.FloatAccuracy(delta=0.0, deltas=deltas)),
    ])


DELTAS_ALGOS = {
    "trim_deltas": (mnw.AlgoCode.TRIM, _sv.pack(1, 0, 0)),
    "trim_v1_1_deltas": (mnw.AlgoCode.TRIM, _sv.pack(1, 1, 0)),
}


def orderfree_segment():
    """Sort v1.2 order-free profile (patch 1): a single-plane UNSI stream,
    the mode-1 wire pinned separately from the ranked fixture."""
    rng = np.random.default_rng(54321)
    n = 4096
    ui = (rng.permutation(1 << 18)[:n] + 3).astype(np.uint64)
    hd = mnw.FieldHeader(mnw.FieldCode.UNSI, mnw.AlgoCode.SORT,
                         _sv.pack(1, 2, 1), n)
    return mnw.Seg(fields=[mnw.Field(hd=hd, data=ui, acc=mnw.IntAccuracy())])


def current_digests():
    out = {}
    for name, (algo, ver) in DELTAS_ALGOS.items():
        blob = api.compress_segment(deltas_segment(algo, ver), seed=888)
        out[f"{name}_encode_sha256"] = hashlib.sha256(blob).hexdigest()
        out[f"{name}_bytes"] = len(blob)
        seg = api.decompress_segment(blob)
        h = hashlib.sha256()
        for f in seg.fields:
            h.update(np.ascontiguousarray(np.asarray(f.data)).tobytes())
        out[f"{name}_decode_sha256"] = h.hexdigest()
    for name, (algo, ver) in ALGOS.items():
        blob = api.compress_segment(reference_segment(algo, ver), seed=777)
        out[f"{name}_encode_sha256"] = hashlib.sha256(blob).hexdigest()
        out[f"{name}_bytes"] = len(blob)
        # decode digest: the dithered output must also be frozen
        seg = api.decompress_segment(blob)
        h = hashlib.sha256()
        for f in seg.fields:
            h.update(np.ascontiguousarray(np.asarray(f.data)).tobytes())
        out[f"{name}_decode_sha256"] = h.hexdigest()
    blob = api.compress_segment(orderfree_segment(), seed=777)
    out["sort_v1_2_orderfree_encode_sha256"] = \
        hashlib.sha256(blob).hexdigest()
    out["sort_v1_2_orderfree_bytes"] = len(blob)
    dec = api.decompress_segment(blob)
    out["sort_v1_2_orderfree_decode_sha256"] = hashlib.sha256(
        np.ascontiguousarray(np.asarray(dec.fields[0].data)).tobytes()
    ).hexdigest()
    return out


def test_wire_digests_frozen():
    got = current_digests()
    if not os.path.exists(FIXTURE):
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        with open(FIXTURE, "w") as f:
            json.dump(got, f, indent=2, sort_keys=True)
        pytest.skip("wire digest fixture generated; commit it")
    with open(FIXTURE) as f:
        want = json.load(f)
    missing = sorted(set(got) - set(want))
    if missing:
        # new frozen versions append their digests; existing entries must
        # never change
        want.update({k: got[k] for k in missing})
        with open(FIXTURE, "w") as f:
            json.dump(want, f, indent=2, sort_keys=True)
        pytest.skip(f"fixture extended with {missing}; commit it")
    mismatches = {k: (want.get(k), got.get(k))
                  for k in sorted(set(want) | set(got))
                  if want.get(k) != got.get(k)}
    assert not mismatches, (
        "FROZEN WIRE FORMAT CHANGED -- bump the algorithm minor version "
        f"instead of editing frozen modules: {mismatches}")
