"""The exact LMC of ``config.json`` as the port runs it: the model, its
starting leaves drawn from the seed, and the training objective that
``training.fit`` drives (the fused PCG MLL, the Nyström roots rebuilt at
the start of every chunk of ``roots_every`` steps)."""

from __future__ import annotations

import torch

from harness import data

LOOPS = ("train",)
# the program's own path one precision below the stated one: the int8
# stack in place of the bf16 one
CONTROL = "int8"


def leaves_from_seed(cfg, seed, device):
    """The trainable raw leaves, by the program's names."""
    g = data.generator(seed, data.LEAVES, device)
    q, t = cfg["q"], cfg["T"]
    noise = lambda shape: data.inv_softplus(                  # noqa: E731
        0.05 * torch.exp(data.uniform(g, shape, -0.5, 0.5, device)) - 1e-4)
    return {
        "covar_module.raw_lengthscale": data.lengthscale_leaf(cfg, g, device),
        "covar_factor": 0.7 * torch.randn((q, t, 1), generator=g,
                                          device=device),
        "likelihood.raw_noise": noise((1,)),
        "likelihood.raw_task_noises": noise((t,)),
    }


def frozen_leaves(cfg, device):
    """Leaves the configuration holds fixed: the per-latent task variances
    at raw −10 (``fix_diagonal``)."""
    return {"raw_var": torch.full((cfg["q"], cfg["T"]), -10.0, device=device)}


def build(pl, cfg, x, y, leaves, device):
    lik = pl.MultitaskGaussianLikelihood(num_tasks=cfg["T"], rank=0,
                                         device=device)
    model = pl.MultitaskGPModel(
        x.cpu().numpy(), y.cpu().numpy(), lik, n_tasks=cfg["T"],
        n_latents=cfg["q"], model_type=cfg["model_type"],
        kernel_type=cfg["kernel_type"], mean_type=cfg["mean_type"],
        fix_diagonal=cfg["fix_diagonal"], device=device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in {**leaves, **frozen_leaves(cfg, device)}.items():
            params[k].copy_(v)
    return model


def objective(pl, cfg, record, variant=None):
    """``loss_fn(model, generator)`` for ``training.fit``: the probes eps
    (s, n, T) and xi (s, q, m) drawn from fit's generator (``record`` keeps
    those of the checked steps), the roots rebuilt every ``roots_every``
    calls. ``variant``: "int8" runs the program's int8 stack (the
    configuration's control); "half" leaves out the second half of the
    rows (a planted fault)."""
    from projected_lmc_tpu_torch.ops import iterative

    kw = dict(cfg["mll"])
    s = kw.pop("num_probes")
    if variant == "int8":
        kw.update(matvec_bf16=False, matvec_int8=True)
    state = {"calls": 0, "roots": None}

    def loss_fn(model, generator):
        x, y = model.train_x, model.train_y
        n = x.shape[0]
        if state["calls"] % cfg["roots_every"] == 0:
            with torch.no_grad():
                state["roots"] = iterative.nystrom_roots_from_covar(
                    model.covar_module, x, kw["precond_rank"],
                    cfg["roots_jitter"])
        m = state["roots"].shape[-1]
        eps = torch.randn((s, n, cfg["T"]), generator=generator,
                          device=x.device)
        xi = torch.randn((s, cfg["q"], m), generator=generator,
                         device=x.device)
        record.probes(state["calls"], eps=eps, xi=xi)
        state["calls"] += 1
        if variant == "half":
            h = n // 2
            mll = model.mll(x=x[:h], y=y[:, :h], eps=eps[:, :h], xi=xi,
                            precond_roots=state["roots"][:, :h], **kw)
        else:
            mll = model.mll(precond_roots=state["roots"], eps=eps, xi=xi,
                            **kw)
        record.loss(mll)
        return mll
    return loss_fn
