"""library_ms: the wall of the spans ``eeyore.library`` (``load_library``:
the headers' hash, the generated headers' hash, the cache lookup, a build
on a miss) and ``eeyore.codegen`` (the dense bodies' text) a job (traced)."""

from harness.program_spans import wall_ms, window


def read(ctx):
    got = window(ctx)
    if got is None:
        return None
    _, records, roots = got
    return wall_ms(records, ("eeyore.library", "eeyore.codegen")) / len(roots)
