"""relayout_ms: the card's time in the span ``eeyore.relayout`` (the
[C, kept, P] copy and the accepted flags), from its CUDA events, a job
(traced); None where the span did not time the card."""

from harness.program_spans import window


def read(ctx):
    got = window(ctx)
    if got is None:
        return None
    _, records, roots = got
    times = [r["device_ms"] for r in records if r["name"] == "eeyore.relayout"]
    if not times or None in times:
        return None
    return sum(times) / len(roots)
