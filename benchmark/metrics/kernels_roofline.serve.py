"""The device operations' share of their roofline in serving: the least
time of the profiled requests' work over the device's busy time in them."""


def read(ctx):
    if ctx.get("loop") != "serve" or not ctx.get("busy_s"):
        return None
    return 100.0 * ctx["profiled_least_s"] / ctx["busy_s"]
