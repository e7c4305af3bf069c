"""The device operations' share of their roofline in training: the least
time of the profiled steps' work over the device's busy time in them (the
union of its operations' intervals)."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("busy_s"):
        return None
    return 100.0 * ctx["least_s"] * ctx["profiled_steps"] / ctx["busy_s"]
