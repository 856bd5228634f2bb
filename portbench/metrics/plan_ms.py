"""plan_ms: the self time of the span ``eeyore.plan`` (``resolve_backend``:
eligibility, the block choice, the tuning-group caps) a job, its library
loads and code generation left out (traced)."""

from harness.program_spans import window


def read(ctx):
    got = window(ctx)
    if got is None:
        return None
    profiling, records, roots = got
    return profiling.self_ms(records, "eeyore.plan") / len(roots)
