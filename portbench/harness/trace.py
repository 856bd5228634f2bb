"""The traced window: ``torch.profiler`` over a fixed number of calls.

From the trace: each device operation's launches and time (a kernel's time
per launch is the mean over the launches the trace holds: the profiler has
been seen to drop launches, and the count is kept beside it), the union of
the device-busy intervals over the traced window, the device operations
that took most time and the longest idle gaps, each named by the innermost
host activity that covers it.
"""

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.traced_window"


def traced_calls(call_once, count):
    """Run ``call_once(i)`` ``count`` times under the profiler; returns the
    parsed trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(count):
                with torch.profiler.record_function("portbench.call"):
                    call_once(i)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def _union(intervals):
    total, end = 0.0, -float("inf")
    merged = []
    for a, b in sorted(intervals):
        if a > end:
            merged.append([a, b])
        elif b > merged[-1][1]:
            merged[-1][1] = b
        end = max(end, b)
    for a, b in merged:
        total += b - a
    return total, merged


def parse(events):
    """{"window_s", "busy_s", "ops": {name: [launches, seconds]}, "gaps":
    [(host activity, seconds)] longest first} of a chrome trace."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no traced window")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, host, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            device.append((a, b))
            entry = ops.setdefault(e["name"], [0, 0.0])
            entry[0] += 1
            entry[1] += (b - a) / 1e6
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    busy, merged = _union(device)
    gaps, cursor = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        covering = [h for h in host if h[0] <= mid <= h[1]]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "host idle"
        named.append((name, (b - a) / 1e6))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "ops": ops, "gaps": named}


def breakdown(parsed):
    top = sorted(parsed["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name, secs] for name, (_, secs) in top],
            "idle_gaps": [[name, secs] for name, secs in parsed["gaps"]]}


def kernel_time(parsed, symbol):
    """(mean seconds a launch, launches traced) of the kernels whose name
    holds ``symbol``."""
    hits = [v for name, v in parsed["ops"].items() if symbol in name]
    count = sum(c for c, _ in hits)
    return (sum(s for _, s in hits) / count if count else None), count
