"""Profiling helpers: wall-clock phase timers, device traces and spans.

Counterpart of ``eeyore_tpu/utils/profiling.py``: phases are timed
explicitly, ``timed`` waits for the card before it stops the clock, and
``device_trace`` records a ``torch.profiler`` trace of the CPU and, when a
card is present, of its kernels, written as a Chrome trace (view it in
Perfetto or chrome://tracing).

Spans. The kernel path of ``sample_chains`` marks its layers with
``span(name)``: ``eeyore.sample_chains`` (the job), ``eeyore.plan``
(``resolve_backend``), ``eeyore.library`` (``ops/_build.load_library``),
``eeyore.codegen`` (the dense bodies of ``ops/mlp_dense.py``),
``eeyore.maker`` (the maker-cache key and lookup), ``eeyore.seed`` (the
kernel seed, one host sync), ``eeyore.launch`` (the maker's function) and
``eeyore.relayout`` (the ``[C, kept, P]`` copy and the accepted flags, timed
on the card too); ``spanned(name)`` makes a whole function a span. A span
does nothing unless a PyTorch profiler is recording, so with tracing off it
costs one flag check. While one records, a span enters
``torch.profiler.record_function``, which puts it into the profiler's Chrome
trace beside the kernels, on the same clock, and keeps a record in memory:
its name, start and end (``time.perf_counter_ns``), the enclosing span's
index, the job (the sequence number of the enclosing
``eeyore.sample_chains`` span), the counters' increase inside it (host
syncs, ``utils/host.py``; library loads and builds,
``ops/_build.load_counts``) and, for a span that times the card, its device
milliseconds. ``spans()`` takes the records (they are dropped as they are
returned, so they do not pile up), ``clear_spans()`` drops them,
``self_ms`` gives a span's time less its children's.

How to trace a run:

- ``with device_trace(log_dir): ...`` writes the Chrome trace
  ``trace_<pid>_<ns>.json`` and takes the records of its window into
  ``spans_<pid>_<ns>.json`` (a list; ``parent`` indexes that list). A
  span whose ``builds`` is not 0 compiled a kernel library: a steady job
  builds none, so there a build is a library that was built again.
- For Nsight Systems, run under ``nsys profile -t cuda,nvtx`` with the code
  inside ``torch.autograd.profiler.emit_nvtx()``: the profiler then emits
  each span's ``record_function`` as an NVTX range, so no code of its own
  is needed (this path has not been run under nsys).
"""

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path

import torch

from eeyore_tpu_torch.utils import host

# the span that makes a job: the spans inside it share its sequence number
JOB = "eeyore.sample_chains"

# the counters whose increase inside a span its record keeps, as ``_counts``
# reads them
_COUNTERS = ("host_syncs", "loads", "builds")

_records = []
_events = {}  # record index -> (start, end) CUDA events not yet read
_jobs = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


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


def span(name, device=None):
    """A context manager marking one layer's work as the span ``name``; a
    shared no-op unless a PyTorch profiler is recording. ``device``: where
    the enclosed work runs; on a CUDA device a pair of CUDA events on its
    current stream also times the work on the card."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device)


def spanned(name):
    """Decorate a function so that each call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _counts():
    from eeyore_tpu_torch.ops import _build  # the ops modules import this one

    return (host.sync_counts["syncs"], _build.load_counts["loads"],
            _build.load_counts["builds"])


class _Span:
    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        job = _records[parent]["job"] if parent is not None else None
        if job is None and self.name == JOB:
            job = next(_jobs)
        self.index = len(_records)
        self.record = {"name": self.name, "start_ns": None, "end_ns": None, "parent": parent,
                       "job": job, **dict.fromkeys(_COUNTERS), "device_ms": None}
        _records.append(self.record)
        stack.append(self.index)
        self.function = torch.autograd.profiler.record_function(self.name)
        self.function.__enter__()
        self.events = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.counts = _counts()
        self.record["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record["end_ns"] = time.perf_counter_ns()
        self.record.update(zip(_COUNTERS, (b - a for a, b in zip(self.counts, _counts()))))
        if self.events is not None:
            self.events[1].record(self.stream)
            _events[self.index] = self.events
        self.function.__exit__(*exc)
        _local.stack.pop()
        return False


def spans():
    """Take the records so far, in the order their spans started (call it
    with no span open): dicts of ``name``, ``start_ns``, ``end_ns``,
    ``parent`` (the enclosing span's index in this list, or None), ``job``,
    the counters' increases ``host_syncs``, ``loads`` and ``builds``, and
    ``device_ms`` (None where the span did not time the card). The records
    are dropped as they are returned. The card's times are read here, after
    waiting for each span's end event, never while it runs."""
    return _take(0)


def _take(first):
    """The records from index ``first`` on, dropped from the list, with
    ``parent`` counted from ``first`` (None where it lay before)."""
    for index in sorted(i for i in _events if i >= first):
        start, end = _events.pop(index)
        end.synchronize()
        _records[index]["device_ms"] = start.elapsed_time(end)
    taken = _records[first:]
    del _records[first:]
    for r in taken:
        if r["parent"] is not None:
            r["parent"] = r["parent"] - first if r["parent"] >= first else None
    return taken


def clear_spans():
    """Drop every record (call it with no span open)."""
    _records.clear()
    _events.clear()


def self_ms(records, name):
    """Milliseconds of the spans called ``name`` in ``records`` (a list as
    ``spans()`` gives it), each less the part of its interval that its child
    spans cover, overlapping children counted once."""
    children = {}
    for r in records:
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append(r)
    total = 0
    for index, r in enumerate(records):
        if r["name"] != name or r["end_ns"] is None:
            continue
        covered, reach = 0, r["start_ns"]
        for c in sorted(children.get(index, ()), key=lambda c: c["start_ns"]):
            a, b = max(c["start_ns"], reach), min(c["end_ns"], r["end_ns"])
            if b > a:
                covered += b - a
                reach = b
        total += r["end_ns"] - r["start_ns"] - covered
    return total / 1e6


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the enclosed code with ``torch.profiler``, write the Chrome
    trace to ``log_dir/trace_<pid>_<ns>.json`` and take the spans recorded
    inside it into ``log_dir/spans_<pid>_<ns>.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    first = len(_records)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(str(log_dir / f"trace_{stamp}.json"))
    (log_dir / f"spans_{stamp}.json").write_text(json.dumps(_take(first)))


def timed(fn, *args, block=True):
    """(result, seconds), the card's queued work included when ``block``."""
    start = time.perf_counter()
    out = fn(*args)
    if block and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, time.perf_counter() - start
