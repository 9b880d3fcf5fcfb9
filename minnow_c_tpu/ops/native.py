"""ctypes bindings to the native host library (``native/minnow_native.cpp``).

Loads ``libminnow_native.so``, building it on first use if the shared object
is missing (mirrors the reference's make-driven lib build,
Makefile:83-101).  All entry points release the GIL for the duration of the
call, so Python-level thread pools achieve real parallelism across
independent fields/blocks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libminnow_native.so")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"native build failed (make -C {_NATIVE_DIR}):\n{r.stderr}")


def _stale() -> bool:
    """Rebuild when sources are newer than the library (the .so is
    untracked and -march=native, so it must always be built locally)."""
    if not os.path.exists(_LIB_PATH):
        return True
    so_m = os.path.getmtime(_LIB_PATH)
    for f in ("minnow_native.cpp", "Makefile"):
        fp = os.path.join(_NATIVE_DIR, f)
        if os.path.exists(fp) and os.path.getmtime(fp) > so_m:
            return True
    return False


def lib() -> ctypes.CDLL:
    """The loaded native library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            _build()
        l = ctypes.CDLL(_LIB_PATH)

        l.mnw_checksum.restype = ctypes.c_uint32
        l.mnw_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_uint32]

        l.mnw_lz4_compress_bound.restype = ctypes.c_int32
        l.mnw_lz4_compress_bound.argtypes = [ctypes.c_int32]

        l.mnw_lz4_compress.restype = ctypes.c_int32
        l.mnw_lz4_compress.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32]

        l.mnw_lz4_decompress.restype = ctypes.c_int32
        l.mnw_lz4_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_void_p, ctypes.c_int32]

        l.mnw_uniform_pack.restype = None
        l.mnw_uniform_pack.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_void_p,
                                       ctypes.c_int32]

        l.mnw_uniform_unpack.restype = None
        l.mnw_uniform_unpack.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_void_p,
                                         ctypes.c_int32]
        _lib = l
        return _lib


def uniform_pack_host(x: np.ndarray, width: int) -> np.ndarray:
    """Host bitpack oracle (bit-exact vs ``bitpack.uniform_pack``)."""
    from . import bitpack
    if not (0 <= width <= 32):
        raise ValueError(f"width {width} not in [0, 32]")
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D array, got shape {x.shape}")
    n_words = bitpack.packed_words(x.size, width)
    out = np.zeros(n_words, dtype=np.uint32)
    lib().mnw_uniform_pack(x.ctypes.data, x.size, width, out.ctypes.data,
                           n_words)
    return out


def uniform_unpack_host(x: np.ndarray, width: int, n: int) -> np.ndarray:
    if not (0 <= width <= 32):
        raise ValueError(f"width {width} not in [0, 32]")
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D array, got shape {x.shape}")
    out = np.zeros(n, dtype=np.uint32)
    lib().mnw_uniform_unpack(x.ctypes.data, x.size, width,
                             out.ctypes.data, n)
    return out
