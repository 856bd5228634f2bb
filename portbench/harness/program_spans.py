"""The spans and counters that the program keeps itself
(``eeyore_tpu_torch.utils.profiling``): its span records, kept in memory
while a profiler records. In a run the traced window is the only such time,
so the records are the window's; each per-layer reader of them divides by
the window's jobs (``eeyore.sample_chains`` spans). A program that keeps no
spans gives None, and so does a window without a job."""


def window(ctx):
    """(profiling module, the records, the jobs' root records), or None.
    The program hands its records over once (``spans()`` drops them), so
    the first reader of a run takes them and keeps them in ``ctx``."""
    if "program_spans" not in ctx:
        ctx["program_spans"] = _take()
    return ctx["program_spans"]


def _take():
    from eeyore_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    records = profiling.spans()
    roots = {}
    for r in records:
        if r["name"] == profiling.JOB and r["job"] is not None:
            roots.setdefault(r["job"], r)
    if not roots:
        return None
    return profiling, records, list(roots.values())


def per_job(ctx, counter):
    """The increase of the program's counter ``counter`` inside a job, or
    None where the program's records do not keep it."""
    got = window(ctx)
    if got is None or counter not in got[2][0]:
        return None
    roots = got[2]
    return sum(r[counter] for r in roots) / len(roots)


def wall_ms(records, names):
    """Milliseconds of the spans called one of ``names``, a span inside
    another of them counted with it once."""
    total = 0
    for r in records:
        if r["name"] not in names or r["end_ns"] is None:
            continue
        parent = r["parent"]
        while parent is not None and records[parent]["name"] not in names:
            parent = records[parent]["parent"]
        if parent is None:
            total += r["end_ns"] - r["start_ns"]
    return total / 1e6
