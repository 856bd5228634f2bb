"""device_idle: 1 - (union of the device-busy intervals) / traced window,
in %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
