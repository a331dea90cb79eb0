"""Profiler integration.

JAX counterpart of the reference's print-based timer instrumentation
(SURVEY §5 tracing): ``device_trace`` captures a ``jax.profiler`` trace
(viewable in TensorBoard / Perfetto) around any analysis region, and
``annotate`` adds named spans so device timelines attribute kernel time
to specific analyses.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path


@contextmanager
def device_trace(logdir: str | Path):
    """Capture a jax.profiler trace of the enclosed region."""
    import jax

    logdir = str(logdir)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span (context manager) for device timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)
