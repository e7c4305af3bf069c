"""Times a training step waits on the device to read a value on the host:
the program's ``host_read`` counts over the profiled steps (the chunk's
loss read included), none where the program records no spans."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["spans"]:
        return None
    return s["counts"]["host_read"] / ctx["profiled_steps"]
