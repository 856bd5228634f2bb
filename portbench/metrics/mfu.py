"""mfu: the window's f32 operations (a call's kernel work times the calls)
at the card's f32 peak (67 TFLOP/s, H100 SXM, outside the tensor cores),
over the window's time, in %."""


def read(ctx):
    if ctx.get("work") is None or ctx.get("peaks") is None or not ctx.get("window_s"):
        return None
    flops = ctx["work"]["flops"] * len(ctx["walls"])
    return 100.0 * flops / ctx["window_s"] / ctx["peaks"]["f32_flops"]
