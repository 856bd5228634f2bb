"""roofline.resident_walk: the least time of a call's resident_walk work (f32 operations at the
f32 peak, or bytes at the memory peak) over the kernel's device time a
launch, from the traced window."""

from harness.layer_metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "resident_walk")
