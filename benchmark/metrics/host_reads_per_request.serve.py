"""Times a request waits on the device inside ``predict`` to read a value
on the host: the program's ``host_read`` counts on its ``predict`` spans
and below them, over the profiled requests (none where the program records
no such span)."""


def read(ctx):
    if ctx.get("loop") != "serve" or not ctx.get("profiled_requests"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary("predict") if summary is not None else None
    if not s or not s["spans"]:
        return None
    return s["counts"]["host_read"] / ctx["profiled_requests"]
