"""maker_ms: the wall of the span ``eeyore.maker`` (the data's copy to the
host, the maker-cache key and lookup, the maker on a miss) a job (traced)."""

from harness.program_spans import wall_ms, window


def read(ctx):
    got = window(ctx)
    if got is None:
        return None
    _, records, roots = got
    return wall_ms(records, ("eeyore.maker",)) / len(roots)
