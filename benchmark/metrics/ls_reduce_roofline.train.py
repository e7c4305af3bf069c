"""The lengthscale reduction's share of its roofline in training: the least
time of the step's "lengthscale reduction" (the work model's count of the
pairs' arithmetic on the rank-(1 + 2s) cotangent, lower triangle) over the
device stretches of the program's ``mll.ls_reduce`` spans, over the
profiled steps. None off a card, where the program records no such span,
or where the cell's work has no such reduction."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary("mll.ls_reduce") if summary is not None else None
    if not s or not s["spans"] or not s["device_ms"]:
        return None
    from harness.stepwork import least_by_name
    least = least_by_name(ctx).get("lengthscale reduction")
    if not least:
        return None
    return 100.0 * least * ctx["profiled_steps"] / (1e-3 * s["device_ms"])
