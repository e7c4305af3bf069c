"""PCG steps a right-hand side takes before it converges or freezes, over
the profiled steps: the program's ``cg.iters`` counts (active steps of
every right-hand side) over its ``cg.solves`` counts (right-hand sides);
at most the configuration's ``max_cg_iters``. None where the program
counts no solve."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["counts"]["cg.solves"]:
        return None
    return s["counts"]["cg.iters"] / s["counts"]["cg.solves"]
