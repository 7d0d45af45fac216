"""Profiling hooks: named scopes for the loop phases + a trace context.

Device counterpart of the reference's ``profile`` cargo feature
(``spin-sim/Cargo.toml:12-13`` + ``inline(never)`` attributes on hot
kernels): phases are annotated with ``jax.named_scope`` so device traces
show clean per-phase frames, and :func:`trace` wraps ``jax.profiler`` for
one-line capture::

    from peapods_tpu.utils.profiling import trace
    with trace("/tmp/trace"):
        model.sample(...)
"""

from __future__ import annotations

import contextlib

import jax

__all__ = ["trace", "phase_scope"]


def phase_scope(name: str):
    """Named scope for one loop phase (shows up in xprof/perfetto traces)."""
    return jax.named_scope(f"peapods/{name}")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device profile of the enclosed block into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
