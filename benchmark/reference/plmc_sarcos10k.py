"""Plain reference of the projected LMC (the paper's model, full B̃, no
block-diagonal noise): its marginal likelihood with autograd gradients,
AdamW, and the served posterior, in plain PyTorch.

With H = QR (complete QR, Q_⊥ the complement), σ_b the projected noises,
B̃ = (L Lᵀ)⁻¹ the discarded noise (L lower triangular, exp diagonal) and M
the cross term, the projected data are T(Y) = R⁻¹QᵀYᵀ + diag(σ) M Q_⊥ᵀYᵀ
and

    ℓ = (1/n) Σ_b log N(T(Y)_b; 0, K_b + σ_b I) + Σ log diag L
        − ½‖(Y Q_⊥) L‖²/n − ½ Σ log R_bb² − ½ (T − q) log 2π.

The posterior mixes the latent exact GPs with H's first q columns and adds
the diagonal of the full task noise Σ = QR D (QR)ᵀ + cross terms + Q_⊥B̃Q_⊥ᵀ
(+ 1e-6, the jitter of its factor). Computed in ``dtype`` (float64 for the
reference; the control runs it in float32 with TF32 on).
"""

from __future__ import annotations

import math

import torch

from reference.common import kernel, softplus, train_steps


def _parts(Y, leaves, cfg):
    q, t = cfg["q"], cfg["T"]
    H = leaves["lmc_coefficients.H"]
    Qp, Rp = torch.linalg.qr(H, mode="complete")
    Q, R, Qo = Qp[:, :q], Rp[:q, :q], Qp[:, q:]
    sigma = softplus(leaves["likelihood.raw_noise"])[:, 0] \
        + math.exp(cfg["noise_thresh"])
    raw = leaves["B_tilde_inv_chol_raw"]
    b = cfg["noise_thresh"]
    L = torch.tril(raw, -1) + torch.diag(torch.exp(
        torch.diagonal(raw).clamp(b, -b)))
    M = leaves["M"]
    proj = torch.linalg.solve_triangular(R, Q.T @ Y.T, upper=True) \
        + sigma[:, None] * (M @ (Qo.T @ Y.T))
    return dict(H=H, Q=Q, R=R, Qo=Qo, sigma=sigma, L=L, M=M, proj=proj,
                ls=softplus(leaves["covar_module.raw_lengthscale"])[:, 0, :])


def _factor(x, ls_b, sigma_b):
    K = kernel(x, x, ls_b)
    K = K + sigma_b * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return torch.linalg.cholesky(K)


def mll(x, Y, leaves, cfg):
    n, t = Y.shape
    q = cfg["q"]
    p = _parts(Y, leaves, cfg)
    latent = 0.0
    for b in range(q):
        Lb = _factor(x, p["ls"][b], p["sigma"][b])
        v = torch.linalg.solve_triangular(Lb, p["proj"][b][:, None],
                                          upper=False)
        latent = latent - 0.5 * ((v * v).sum()
                                 + 2.0 * torch.log(torch.diagonal(Lb)).sum()
                                 + n * math.log(2 * math.pi))
    root = (Y @ p["Qo"]) @ p["L"]
    return latent / n + torch.log(torch.diagonal(p["L"])).sum() \
        - 0.5 * (root * root).sum() / n \
        - 0.5 * torch.log(torch.diagonal(p["R"]) ** 2).sum() \
        - 0.5 * (t - q) * math.log(2 * math.pi)


def train(x, Y, leaves, cfg, steps, dtype=torch.float64):
    """``steps`` AdamW steps of −ℓ from ``leaves``, in ``dtype``; returns
    (losses, first gradients, leaves after the steps)."""
    x, Y = x.to(dtype), Y.to(dtype)
    start = {k: v.to(dtype) for k, v in leaves.items()}

    def loss_and_grads(cur, i):
        leaf = {k: v.detach().clone().requires_grad_(True)
                for k, v in cur.items()}
        loss = -mll(x, Y, leaf, cfg)
        grads = torch.autograd.grad(loss, list(leaf.values()))
        return loss.detach(), dict(zip(leaf, grads))

    opt = cfg["optimizer"]
    return train_steps(start, loss_and_grads, steps, opt["lr"],
                       opt["weight_decay"])


def task_noise_diag(p):
    """diag(Σ) + 1e-6 of the full p×p task noise."""
    QR, Qo, sig, M = p["Q"] @ p["R"], p["Qo"], p["sigma"], p["M"]
    Linv = torch.linalg.inv(p["L"])
    Bt = Linv.T @ Linv
    SM = sig[:, None] * M
    B_term = Qo @ Bt @ Qo.T
    M_term = -QR @ SM @ Bt @ Qo.T
    D = torch.diag(sig) + SM @ Bt @ (M.T * sig[None, :])
    Sigma = QR @ D @ QR.T + M_term + M_term.T + B_term
    return torch.diagonal(Sigma) + 1e-6


class Posterior:
    """The served posterior: the latent systems factored once, then the
    mean and variance (with the observation noise) at any test inputs."""

    def __init__(self, x, Y, leaves, cfg, dtype=torch.float64):
        self.x = x.to(dtype)
        leaves = {k: v.to(dtype) for k, v in leaves.items()}
        with torch.no_grad():
            p = _parts(Y.to(dtype), leaves, cfg)
            self.ls = p["ls"]
            self.L, self.alpha = [], []
            for b in range(cfg["q"]):
                Lb = _factor(self.x, self.ls[b], p["sigma"][b])
                self.L.append(Lb)
                self.alpha.append(torch.cholesky_solve(p["proj"][b][:, None],
                                                       Lb)[:, 0])
            self.mix = p["H"][:, :cfg["q"]].T               # (q, T)
            self.noise = task_noise_diag(p)

    @torch.no_grad()
    def __call__(self, x_star):
        xs = x_star.to(self.x.dtype)
        means, vars_ = [], []
        for b, Lb in enumerate(self.L):
            Ks = kernel(self.x, xs, self.ls[b])             # (n, n*)
            means.append(Ks.T @ self.alpha[b])
            V = torch.linalg.solve_triangular(Lb, Ks, upper=False)
            vars_.append((1.0 - (V * V).sum(0)).clamp_min(1e-12))
        mean = torch.stack(means).T @ self.mix
        var = torch.stack(vars_).T @ (self.mix * self.mix) + self.noise
        return mean, var
