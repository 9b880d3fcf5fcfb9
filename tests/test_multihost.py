"""Real multi-process SPMD test: two coordinator-connected CPU processes
form one global mesh and run the sharded position codec end-to-end.

This exercises the actual jax.distributed code paths (process-local
shards, cross-process SPMD execution, collectives) that a multi-host
deployment uses, with DCN emulated over localhost."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
proc_id = int(sys.argv[1]); coord = sys.argv[2]; tmp = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.getcwd())
from minnow_c_tpu.parallel import multihost
multihost.initialize(coord, 2, proc_id)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

import numpy as np
from jax.sharding import Mesh
from minnow_c_tpu.parallel.sharding import ShardedPositionCodec, \
    spmd_depth_for

W = 64.0
mesh = Mesh(np.array(jax.devices()), ("dp",))
codec = ShardedPositionCodec(mesh=mesh, width=W,
                             depth=spmd_depth_for(1e-3, W))

# deterministic global data; this process owns blocks [4p, 4p+4)
rng = np.random.default_rng(0)
gx = rng.uniform(0, W, (8, 3, 256)).astype(np.float32)
local = gx[proc_id * 4:(proc_id + 1) * 4]
xg = multihost.global_block_array(local.reshape(12, 256), mesh)  # ROWS

words, x0, rng_b = codec.encode(xg)
out = codec.decode(words, x0, rng_b, seed=5)
mine = multihost.local_block_slice(out, mesh).reshape(4, 3, 256)
ref = gx[proc_id * 4:(proc_id + 1) * 4]
err = np.abs(mine - ref); err = np.minimum(err, W - err)
assert err.max() <= 1e-3, err.max()
# cross-process collective: global range agrees on both processes
g = codec.global_range(xg)

# Full-snapshot codec over the same two-process mesh: the vel dither
# key offset uses psum over the mesh axis (a real cross-process
# collective at trace time) and IDs must be lossless end to end.
from minnow_c_tpu.parallel.sharding import ShardedSnapshotCodec
from minnow_c_tpu.quant.engine import delta_to_depth
gv = rng.normal(0, 200, (8, 3, 256)).astype(np.float32)
gi = rng.permutation(1024 * 1024 * 2)[: 8 * 256].astype(
    np.uint64).reshape(8, 256)
snap = ShardedSnapshotCodec(
    mesh=mesh, box=W, pos_depth=spmd_depth_for(1e-3, W),
    vel_depth=delta_to_depth(1.0, -1000.0, 1000.0), id_grid=1024)
vg = multihost.global_block_array(
    gv[proc_id * 4:(proc_id + 1) * 4].reshape(12, 256), mesh)
ig = multihost.global_block_array(gi[proc_id * 4:(proc_id + 1) * 4], mesh)
enc = snap.encode(xg, vg, ig)
dpos, dvel, dids = snap.decode(enc, seed=5)
mpos = multihost.local_block_slice(dpos, mesh).reshape(4, 3, 256)
perr = np.abs(mpos - ref); perr = np.minimum(perr, W - perr)
assert perr.max() <= 1e-3, perr.max()
mvel = multihost.local_block_slice(dvel, mesh).reshape(4, 3, 256)
assert np.abs(mvel - gv[proc_id * 4:(proc_id + 1) * 4]).max() <= 1.0
mids = multihost.local_block_slice(dids, mesh)
assert np.array_equal(mids, gi[proc_id * 4:(proc_id + 1) * 4])
# position bits must equal the position-only codec's (shared streams)
assert np.array_equal(mpos, mine)

# ---- distributed file write (doc/separation_of_duties.md:7-12): each
# process compresses its OWN blocks; segments land in one chained file
# in global block order, readable by the scalar path.
import io
import minnow_c_tpu as mnw
from minnow_c_tpu.parallel import snapshot as snap_mod

def slab(blocks):   # (B_local, d, nb) -> (d, B_local*nb) / (B_local, nb)->(n,)
    if blocks.ndim == 3:
        return np.concatenate([blocks[b] for b in range(blocks.shape[0])],
                              axis=1)
    return blocks.reshape(-1)

spec = snap_mod.SnapshotSpec(
    pos=mnw.PositionAccuracy(delta=1e-3, width=W),
    vel=mnw.VelocityAccuracy(delta=1.0),
    ids=mnw.IDAccuracy(width=1024))
lo, hi = proc_id * 4, (proc_id + 1) * 4
path = os.path.join(tmp, "multi.min")
fp = open(path, "wb") if proc_id == 0 else None
st = snap_mod.compress_snapshot_multihost(
    fp, slab(gx[lo:hi]), slab(gv[lo:hi]), slab(gi[lo:hi]), spec,
    num_blocks_local=4, seed=5)
if fp is not None:
    fp.close()
assert st["num_blocks"] == 8, st
# every process reads the one file back and sees the full snapshot in
# global block order
with open(path, "rb") as f:
    full = snap_mod.decompress_snapshot(f)
gpos = np.concatenate([gx[b] for b in range(8)], axis=1)
gids = gi.reshape(-1)
ferr = np.abs(full["pos"] - gpos); ferr = np.minimum(ferr, W - ferr)
assert ferr.max() <= 1e-3, ferr.max()
assert np.abs(full["vel"] -
              np.concatenate([gv[b] for b in range(8)], axis=1)).max() <= 1.0
assert np.array_equal(full["ids"], gids)
if proc_id == 0:
    # POSN/VELC/PTID streams must ALL be byte-identical to a single-host
    # write of the concatenated data: float depths are synced by the
    # range all-gather, and the PTID frame by the element-0 anchor +
    # global-min sync (round-5: topology-independent bytes).
    from minnow_c_tpu.segment import format as wire_fmt
    from minnow_c_tpu.segment import io as seg_io_mod
    buf = io.BytesIO()
    snap_mod.compress_snapshot(buf, gpos,
                               np.concatenate([gv[b] for b in range(8)],
                                              axis=1),
                               gids, spec, num_blocks=8, seed=5)
    buf.seek(0)
    ref_segs = [s for _, s in seg_io_mod.iter_segments(buf)]
    with open(path, "rb") as f:
        got_segs = [s for _, s in seg_io_mod.iter_segments(f)]
    assert len(ref_segs) == len(got_segs) == 8
    POSN, VELC = int(mnw.FieldCode.POSN), int(mnw.FieldCode.VELC)
    PTID = int(mnw.FieldCode.PTID)
    for rs, gs in zip(ref_segs, got_segs):
        rf = {f.field_code: f.blocks for f in wire_fmt.deserialize(rs).fields}
        gf = {f.field_code: f.blocks for f in wire_fmt.deserialize(gs).fields}
        assert rf[POSN] == gf[POSN]
        assert rf[VELC] == gf[VELC]
        assert rf[PTID] == gf[PTID], "PTID bytes not topology-independent"
    print("FILE_PARITY_OK", flush=True)

# ---- distributed file READ (round-5): each process skip-ahead-reads
# ONLY its rank-major slice of segments from the one shared file and the
# slabs assemble into global block-sharded arrays.
class SpanRecordingFile:
    # binary file wrapper recording (offset, length) of every read
    def __init__(self, f):
        self.f = f; self.spans = []
    def read(self, n=-1):
        off = self.f.tell(); data = self.f.read(n)
        self.spans.append((off, len(data))); return data
    def seek(self, *a): return self.f.seek(*a)
    def tell(self): return self.f.tell()

with open(path, "rb") as f:
    rf = SpanRecordingFile(f)
    got = snap_mod.decompress_snapshot_multihost(rf, mesh=mesh)
assert got["num_blocks"] == 8 and got["blocks_local"] == 4
# local slabs: bit-identical to the single-process full read's slice
n_slab = 4 * 256
assert np.array_equal(got["local"]["pos"],
                      full["pos"][:, proc_id * n_slab:(proc_id + 1) * n_slab])
assert np.array_equal(got["local"]["vel"],
                      full["vel"][:, proc_id * n_slab:(proc_id + 1) * n_slab])
assert np.array_equal(got["local"]["ids"],
                      gi[lo:hi].reshape(-1))
# error bound directly vs the original data
rerr = np.abs(got["local"]["pos"] - slab(gx[lo:hi]))
rerr = np.minimum(rerr, W - rerr)
assert rerr.max() <= 1e-3, rerr.max()
# skip-ahead: foreign segment bodies were never read.  Compute each
# segment's body span from the chain and intersect with recorded reads.
from minnow_c_tpu.segment import io as seg_io2
with open(path, "rb") as f:
    offs = []
    off = 0
    for hd in seg_io2.iter_headers(f):
        offs.append((off + seg_io2.IO_HEADER_BYTES, hd.segment_bytes))
        off = hd.next_io_header
foreign = [offs[i] for i in range(8)
           if not (proc_id * 4 <= i < (proc_id + 1) * 4)]
for (fo, fl) in foreign:
    for (ro, rl) in rf.spans:
        assert not (ro < fo + fl and fo < ro + rl), \
            f"read ({ro},{rl}) overlaps foreign body ({fo},{fl})"
# global sharded arrays round-trip through local_block_slice
g_ids = multihost.local_block_slice(got["ids"], mesh)
assert np.array_equal(g_ids, gi[lo:hi])
g_pos = multihost.local_block_slice(got["pos"], mesh)
assert np.array_equal(g_pos.reshape(4, 3, 256),
                      np.stack([got["local"]["pos"][:, b*256:(b+1)*256]
                                for b in range(4)]))
print("READ_OK", proc_id, flush=True)

with open(os.path.join(tmp, f"ok{proc_id}"), "w") as f:
    f.write(f"{g:.6f}")
print("WORKER_OK", proc_id, flush=True)
"""


def test_two_process_spmd(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), coord, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=cwd) for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i}:\n{out[-3000:]}"
        assert f"WORKER_OK {i}" in out
        assert f"READ_OK {i}" in out
    # both processes agreed on the all-reduced header value
    g0 = (tmp_path / "ok0").read_text()
    g1 = (tmp_path / "ok1").read_text()
    assert g0 == g1
