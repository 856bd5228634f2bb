"""Profiling helpers: wall-clock phase timers and device traces.

Counterpart of ``eeyore_tpu/utils/profiling.py``: phases are timed
explicitly, ``timed`` waits for the card before it stops the clock, and
``device_trace`` records a ``torch.profiler`` trace of the CPU and, when a
card is present, of its kernels, written as a Chrome trace (view it in
Perfetto or chrome://tracing).
"""

import contextlib
import os
import time
from pathlib import Path

import torch


class PhaseTimer:
    """Accumulates the wall-clock seconds of named phases."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - start

    def report(self):
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the enclosed code with ``torch.profiler`` and write the Chrome
    trace to ``log_dir/trace_<pid>_<ns>.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timed(fn, *args, block=True):
    """(result, seconds), the card's queued work included when ``block``."""
    start = time.perf_counter()
    out = fn(*args)
    if block and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - start
