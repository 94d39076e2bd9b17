"""Tracing / profiling facilities (SURVEY.md §5.1).

The reference's tracing is a compile-time `trace!` macro gated on
`DO_PRINTS` (fast_simd.rs:56-67) plus wall-clock prints.  Equivalents here:

  * `trace(...)`: host-side trace prints gated by the FDF_TRACE env var
    (zero overhead when off — calls are cheap no-ops, and kernel-side
    prints should use `pl.debug_print` directly under the same flag),
  * `profile(dir)`: context manager around `jax.profiler` emitting a
    Perfetto-compatible trace of device execution,
  * `annotate(name)`: TraceAnnotation for labeling pipeline stages in the
    profile.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

TRACE_ENV = "FDF_TRACE"


def tracing_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "0") not in ("", "0", "false")


def trace(*args) -> None:
    """Host-side trace print, enabled by FDF_TRACE=1 (the `trace!`
    analogue, opencv_compat.rs:31-39)."""
    if tracing_enabled():
        print("[fdf]", *args)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view with Perfetto / TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a code span in profiler traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
