"""Device time a request spends in the n*-column triangular solve of the
latent posterior: the device stretches of the program's ``predict.solve``
spans over the profiled requests (none off a card, or where the program
records no such span)."""


def read(ctx):
    if ctx.get("loop") != "serve" or not ctx.get("profiled_requests"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary("predict.solve") if summary is not None else None
    if not s or not s["spans"] or s["device_ms"] is None:
        return None
    return s["device_ms"] / ctx["profiled_requests"]
