"""torch.profiler integration, as in tpufem.utils.profiling (which wraps
jax.profiler): trace capture for solver and assembly runs.

    from tpufem_torch.utils.profiling import trace, annotate
    with trace("traces/run"):
        with annotate("solve"):
            sol = solve_poisson_fast(...)
    # a Chrome trace (chrome://tracing, Perfetto) under traces/run

``trace`` records the host's activity, and the card's where one is
present, and writes the trace on exit.  ``annotate(name)`` is a named
region of the timeline (``torch.profiler.record_function``).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a trace of the enclosed block into
    ``log_dir/trace-<pid>-<ns>.json``.  ``create_perfetto_link`` (a
    jax.profiler service) has no torch counterpart and raises."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link is jax.profiler's; "
                         "torch.profiler writes a Chrome trace to open "
                         "in Perfetto")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named region in the profiler timeline."""
    return record_function(name)
