"""Profiling and tracing helpers.

The reference's only observability is its benchmark harness
(src/bench.{h,c}); here the device-side equivalents are:

* ``trace(dir)``     -- context manager around the JAX profiler; the
  resulting trace opens in TensorBoard/Perfetto and shows every XLA
  kernel on the device timeline.
* ``annotate(name)`` -- named trace span for host-side phases (entropy,
  serialization) so host and device time are attributable.
* ``timed(name)``    -- lightweight wall-clock span logger for quick
  printf-style profiling without the profiler.
* ``phase(name)``    -- the production span: always an ``annotate``;
  additionally a ``timed`` print when ``MINNOW_PROFILE`` is set.  The
  snapshot writer/reader wrap their pipeline phases (stats, bin+pack,
  D2H gather, entropy, serialize, decode) in these, so
  ``MINNOW_PROFILE=1 python ...`` attributes wall time per phase and a
  ``trace()`` capture shows the same names on the device timeline.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/minnow_trace"):
    """Capture a JAX profiler trace for the enclosed block."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    import jax
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def phase(name: str, sink=print, nbytes: int = 0):
    """Production pipeline span: a profiler ``annotate`` always, plus a
    wall-clock ``timed`` print when the ``MINNOW_PROFILE`` env var is
    set.  ``nbytes`` (optional) adds a GB/s figure to the print."""
    with contextlib.ExitStack() as st:
        st.enter_context(annotate(name))
        if os.environ.get("MINNOW_PROFILE"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                rate = f"  ({nbytes / dt / 1e9:.2f} GB/s)" \
                    if nbytes and dt > 0 else ""
                sink(f"[minnow] {name}: {dt * 1e3:.2f} ms{rate}")
        else:
            yield


@contextlib.contextmanager
def timed(name: str, sink=print):
    """Wall-clock span: ``with timed("lz4"): ...`` prints the elapsed
    time.  Blocks on nothing -- callers must block_until_ready around
    device work they want attributed."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"[minnow] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
