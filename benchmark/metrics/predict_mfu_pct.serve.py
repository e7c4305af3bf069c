"""The served requests' share of the chip's peak: the least time of their
work over the window's wall time (the profiled requests left out of
both)."""


def read(ctx):
    if ctx.get("loop") != "serve" or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["least_s"] / ctx["wall_s"]
