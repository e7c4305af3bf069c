"""Right-hand sides a training step's PCG freezes at its breakdown guard
(a step α that is NaN, infinite or ≤ 1e-30): the program's ``cg.frozen``
counts over the profiled steps, 0 on a sound run. None where the program
counts no solve."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["counts"]["cg.solves"]:
        return None
    return s["counts"]["cg.frozen"] / ctx["profiled_steps"]
