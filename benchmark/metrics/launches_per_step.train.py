"""Kernel launches per training step, counted on the profiler's device
timeline over the profiled steps (memory copies and sets left out)."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    return ctx["kernels"] / ctx["profiled_steps"]
