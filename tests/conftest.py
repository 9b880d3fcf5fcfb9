"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
paths are exercised without accelerator hardware (SURVEY.md section 4,
multi-node testing note).  Must run before jax is imported anywhere.

Tests that need the card carry the ``gpu`` marker and skip inside the
``gpu_device`` fixture when there is none; nothing here decides at
import time which tests exist."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compile cache (minnow_c_tpu.utils.compile_cache): the suite
# jit-compiles many (width, shape) variants; caching keeps reruns fast.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402
import pytest  # noqa: E402

from minnow_c_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_executables():
    """Drop compiled XLA programs after every test module.

    Every jitted program holds mmap'd JIT code pages for the process
    lifetime; this suite compiles enough distinct programs that a full
    run crosses vm.max_map_count (default 65530 -- measured 65,256 maps
    at death) and the next mmap failure inside LLVM/zstd kills the
    process as a SIGSEGV, SIGABRT, or llvm-worker deadlock at whichever
    compile happens to run last (observed 7/7 at the suite's largest
    program, the ShardedSnapshotCodec decode, while every subset of the
    suite passes).  Clearing jax's executable caches between modules
    keeps the map count bounded; within-module compile reuse is
    unaffected."""
    yield
    jax.clear_caches()
