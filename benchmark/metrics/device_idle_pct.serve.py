"""The device's idle share over the profiled requests: 100 less the union
of its operations' intervals over the profiled wall time."""


def read(ctx):
    if ctx.get("loop") != "serve" or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
