"""Share of the Cholesky pullbacks over the profiled steps that take the
Gaussian log-density's closed form: the program's
``cholesky.pullback.closed_form`` counts over its ``cholesky.pullback``
counts (1 when every pullback is the closed form), none where the program
counts no pullback."""


def read(ctx):
    if ctx.get("loop") != "train" or not ctx.get("profiled_steps"):
        return None
    from projected_lmc_tpu_torch.utils import profiling
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["counts"]["cholesky.pullback"]:
        return None
    return (s["counts"]["cholesky.pullback.closed_form"]
            / s["counts"]["cholesky.pullback"])
