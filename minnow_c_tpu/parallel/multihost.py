"""Multi-host (multi-process) SPMD setup helpers.

BASELINE config 5 targets 1B-particle batches across 2+ hosts.  The
recipe: every process calls ``initialize()`` (jax.distributed) so all
hosts' devices form one global mesh; block-DP sharded arrays are built
from per-host local shards with ``make_array_from_process_local_data``;
the codec's SPMD programs (``sharding.ShardedPositionCodec``) then run
unchanged -- XLA inserts the collectives for the header all-reduce, and
each host writes the segments of its own blocks (ordered gather by block
index).

Several processes on one GPU host must each take their own card
(``local_device_ids``): a JAX process reserves most of a card's memory
when it first uses it, so ranks that all claim every card run out of
memory.  The logic is tested with two coordinator-connected CPU processes
on one machine (tests/test_multihost.py), which exercises the same
jax.distributed code paths; no multi-process run on GPUs has been made
yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the jax.distributed cluster (no-op for single-process).

    ``local_device_ids``: the cards of this host this process uses; ranks
    that share a host pass their own, e.g. ``[local_rank]`` for one rank
    per card.  None takes every local device."""
    import jax
    if coordinator_address is not None and num_processes is None:
        # Forward for auto-detection rather than silently staying
        # single-process (which would make every host build its own
        # disjoint "global" array with no error).
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   process_id=process_id,
                                   local_device_ids=local_device_ids)
        return
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_block_array(local_blocks: np.ndarray, mesh):
    """Assemble a globally-sharded (B, ...) block array from this
    process's local blocks.  ``local_blocks`` holds this host's
    contiguous slice of the global block axis; all hosts must pass equal
    counts."""
    import jax

    n_proc = jax.process_count()
    global_shape = (local_blocks.shape[0] * n_proc,) + \
        local_blocks.shape[1:]
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(mesh.axis_names[0]))
    return jax.make_array_from_process_local_data(sharding, local_blocks,
                                                  global_shape)


def local_block_slice(global_out, mesh):
    """This process's addressable slice of a block-sharded result, as a
    numpy array in global block order.

    Replicated mesh axes (anything beyond ``mesh.axis_names[0]``) yield
    one addressable shard per REPLICA; keep only replica 0 of each
    block range or the result would duplicate blocks."""
    shards = [s for s in global_out.addressable_shards
              if s.replica_id == 0]
    shards.sort(key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def allgather_max_f32(x: float) -> float:
    """All-reduce max of a host-side f32 scalar across processes (the
    one sync the shared-depth policy needs; quant.c:195 analog)."""
    import jax
    if jax.process_count() <= 1:
        return float(np.float32(x))
    from jax.experimental import multihost_utils
    g = multihost_utils.process_allgather(
        np.asarray([x], dtype=np.float32))
    return float(np.float32(np.max(g)))


def allgather_i64(arr) -> np.ndarray:
    """All-gather an int64 array across processes; returns (P, *shape)
    rank-major.  Single-process: (1, *shape) view of the input."""
    import jax
    arr = np.asarray(arr, dtype=np.int64)
    if jax.process_count() <= 1:
        return arr[None]
    from jax.experimental import multihost_utils
    g = np.asarray(multihost_utils.process_allgather(arr))
    return g.reshape(jax.process_count(), *arr.shape)


def allgather_bytes(blobs):
    """All-gather per-process byte-string lists: every process passes an
    equal-length list; returns the rank-major concatenation (process 0's
    blobs first).  Implemented with one length gather + one padded u8
    gather over jax.distributed."""
    import jax
    if jax.process_count() <= 1:
        return list(blobs)
    from jax.experimental import multihost_utils
    lens = np.asarray([len(b) for b in blobs], dtype=np.int64)
    all_lens = multihost_utils.process_allgather(lens)  # (P, k)
    if all_lens.ndim == 1:
        all_lens = all_lens.reshape(jax.process_count(), -1)
    if all_lens.shape[1] != len(blobs):
        raise ValueError("allgather_bytes requires equal blob counts on "
                         "every process")
    lmax = int(all_lens.max())
    pad = np.zeros((len(blobs), lmax), dtype=np.uint8)
    for i, b in enumerate(blobs):
        pad[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    allb = multihost_utils.process_allgather(pad)  # (P, k, lmax)
    if allb.ndim == 2:
        allb = allb.reshape(jax.process_count(), len(blobs), lmax)
    out = []
    for p in range(all_lens.shape[0]):
        for i in range(all_lens.shape[1]):
            out.append(allb[p, i, : all_lens[p, i]].tobytes())
    return out


def barrier(name: str = "minnow") -> None:
    """Cross-process barrier (file-visibility fence around writes)."""
    import jax
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
