"""dispatch_ms: a call's host wall (the median of the window's calls) less
its whole-loop kernel's device time a launch (traced): dispatch, the
re-layout to [C, kept, P], the flags and the ChainLists, and the gaps
between them."""

from harness.layer_metrics import kernel_seconds, median_wall


def read(ctx):
    wall, kernel = median_wall(ctx), kernel_seconds(ctx)
    if wall is None or kernel is None:
        return None
    return 1e3 * (wall - kernel)
