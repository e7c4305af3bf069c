"""Device time a training step spends in the MLL's PCG loop, its M⁻¹
applies and stack products included: the device stretches of the
program's ``mll.pcg`` spans over the profiled steps (none off a card, or
where the program records no such span)."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary("mll.pcg") if summary is not None else None
    if not s or not s["spans"] or s["device_ms"] is None:
        return None
    return s["device_ms"] / ctx["profiled_steps"]
