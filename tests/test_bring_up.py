"""What runs the codec on a GPU, checked on the CPU: the one host-or-device
choice of the chunked codecs, the compile-cache location, the device
records of the benchmarks, the multi-process card assignment, and the
phases of ``chip_smoke.py`` at tiny sizes (only its ``main()`` insists
on a GPU)."""

import io
import json
import os
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


class _FakeArray:
    """Duck-typed stand-in for an array living on another platform."""

    def __init__(self, platform):
        self._dev = types.SimpleNamespace(platform=platform)

    def devices(self):
        return [self._dev]


@pytest.mark.parametrize("array,want", [
    (np.zeros(4, np.uint32), False),             # host: the default device
    (jnp.zeros(4, jnp.uint32), False),           # a CPU jax array
    (_FakeArray("gpu"), True),                   # an accelerator array
    (_FakeArray("cpu"), False),
])
def test_use_device_follows_array_platform(array, want):
    from minnow_c_tpu.algos import chunked
    assert chunked.use_device(array) is want


def test_use_device_follows_default_device_for_host_arrays():
    """A host array goes where JAX would place it: the device side under
    ``jax.default_device`` of an accelerator platform."""
    from minnow_c_tpu.algos import chunked
    with jax.default_device("gpu"):
        assert chunked.use_device(np.zeros(4, np.uint32)) is True
    with jax.default_device(jax.devices("cpu")[0]):
        assert chunked.use_device(np.zeros(4, np.uint32)) is False


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from minnow_c_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from minnow_c_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable()
        assert path == os.path.join(REPO, ".jax_cache")
        assert compile_cache.cache_dir() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    from minnow_c_tpu.bench import harness
    with pytest.raises(SystemExit, match="no GPU"):
        harness.require_gpu()


def test_device_record_names_device():
    from minnow_c_tpu.bench import harness
    rec = harness.device_record()
    assert rec["platform"] == "cpu" and rec["device_count"] == 8
    assert set(rec) == {"platform", "device_kind", "device_count", "card"}


def test_initialize_forwards_local_device_ids(monkeypatch):
    from minnow_c_tpu.parallel import multihost
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    multihost.initialize("localhost:1234", 4, 2, local_device_ids=[2])
    multihost.initialize("localhost:1234", 1, 0)  # single process: no-op
    assert calls == [{"coordinator_address": "localhost:1234",
                      "num_processes": 4, "process_id": 2,
                      "local_device_ids": [2]}]


def test_chip_smoke_refuses_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = chip_smoke.main([])
    assert rc != 0
    assert "{" not in buf.getvalue()  # no result line


def test_chip_smoke_snapshot_data():
    pos, vel, ids = chip_smoke.make_snapshot(16, seed=3)
    n = 16 ** 3
    assert pos.shape == (3, n) and vel.shape == (3, n) and ids.shape == (n,)
    assert pos.dtype == np.float32 and ids.dtype == np.uint64
    assert pos.min() >= 0 and pos.max() < chip_smoke.BOX
    np.testing.assert_array_equal(ids, np.arange(n, dtype=np.uint64))
    # particle (ix, iy, iz) = (5, 2, 0) sits near its lattice site
    cell = chip_smoke.BOX / 16
    i = 5 + 16 * 2
    assert abs(pos[0, i] - 5 * cell) < 2 * cell
    assert abs(pos[1, i] - 2 * cell) < 2 * cell
    again = chip_smoke.make_snapshot(16, seed=3)
    np.testing.assert_array_equal(again[0], pos)


def test_chip_smoke_numerics_phase():
    out = chip_smoke.phase_numerics(n_div=4096, n_pack=100,
                                    widths=[1, 9, 17, 32])
    assert out["div_exact_mismatches"] == 0
    assert out["div_bin_mismatches"] == 0 and not out["pack_bad_widths"]


def test_chip_smoke_wire_phase():
    out = chip_smoke.phase_wire(names=["trim", "coil_v1_1",
                                       "trim_v1_1_deltas",
                                       "sort_v1_2_orderfree"])
    assert out["streams"] == 4 and out["floats"] > 0


def test_chip_smoke_snapshot_phase(tmp_path):
    snap = chip_smoke.make_snapshot(32, seed=1)
    res = chip_smoke.phase_snapshot(*snap, 32, 2, 1, workdir=str(tmp_path))
    assert res["pos_err"] <= chip_smoke.POS_DELTA
    assert res["vel_err"] <= chip_smoke.VEL_DELTA


def test_chip_smoke_delta_phase():
    pos = chip_smoke.make_snapshot(16, seed=2)[0]
    res = chip_smoke.phase_delta_family(np.ascontiguousarray(pos), 2)
    assert set(res) == {"Coil v1.1", "Octo v1.1", "Sort v1.2"}


def test_chip_smoke_four_card_phase(tmp_path):
    snap = chip_smoke.make_snapshot(16, seed=4)
    res = chip_smoke.phase_four_cards(*snap, 16, 4, num_blocks=8, cards=4,
                                      workdir=str(tmp_path))
    assert res["streams_equal"]


@pytest.mark.gpu
def test_numerics_on_card(gpu_device):
    """The numerics phase at full size on the card (``pytest -m gpu``)."""
    out = chip_smoke.phase_numerics()
    assert out["div_exact_mismatches"] == 0
    assert json.dumps(out)
