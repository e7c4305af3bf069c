"""Factorizations the Cholesky jitter ladder attempts per factor it
returns, over the profiled steps: the program's ``cholesky.try`` counts
over its ``cholesky.factor`` counts (1 when no rung is climbed), none
where the program counts no factor."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["counts"]["cholesky.factor"]:
        return None
    return s["counts"]["cholesky.try"] / s["counts"]["cholesky.factor"]
