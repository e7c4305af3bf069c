"""The stack products' share of their roofline in training: the least time
of the step's products with the (q, n, n) kernel stack (the work model's
"CG stack product" and "backward stack product", the stack counted on its
lower triangle) over the device stretches of the program's
``mll.stack_product`` spans, over the profiled steps. None off a card,
where the program records no such span, or where the cell's work has no
stack product."""

NAMES = ("CG stack product", "backward stack product")


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary("mll.stack_product") if summary is not None else None
    if not s or not s["spans"] or not s["device_ms"]:
        return None
    from harness.stepwork import least_by_name
    least = sum(v for k, v in least_by_name(ctx).items() if k in NAMES)
    if not least:
        return None
    return 100.0 * least * ctx["profiled_steps"] / (1e-3 * s["device_ms"])
