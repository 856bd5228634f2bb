"""Arithmetic that the per-layer metric readers share. A reader gets the
run's context: ``cell``, ``trace`` (``harness.trace.parse``), ``walls``
(each window call's host seconds), ``window_s``, ``work`` ({"flops",
"bytes"} of one call's kernel) and ``peaks``; it returns None where the run
gives it nothing to read."""

import statistics

from harness.trace import kernel_time


def kernel_seconds(ctx):
    if ctx.get("trace") is None:
        return None
    seconds, _ = kernel_time(ctx["trace"], ctx["cell"].spec["kernel_symbol"])
    return seconds


def least_time(ctx):
    """(least seconds of one call's kernel work on the card, the bound's
    side: "f32" or "bytes")."""
    w, p = ctx["work"], ctx["peaks"]
    t_ops, t_bytes = w["flops"] / p["f32_flops"], w["bytes"] / p["hbm_bytes"]
    return (t_ops, "f32") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_share(ctx, kernel):
    """The kernel's least time over its device time a launch, in %."""
    if ctx["cell"].kernel != kernel or ctx.get("peaks") is None or ctx.get("work") is None:
        return None
    seconds = kernel_seconds(ctx)
    if not seconds:
        return None
    return 100.0 * least_time(ctx)[0] / seconds


def median_wall(ctx):
    return statistics.median(ctx["walls"]) if ctx.get("walls") else None
