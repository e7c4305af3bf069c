"""The training step's share of the chip's peak: the least time of the
step's work (``configs/<config>/work.py`` over ``harness/peaks.py``) over
the wall time per step of the window's steps outside the profiled ones."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("step_s"):
        return None
    return 100.0 * ctx["least_s"] / ctx["step_s"]
