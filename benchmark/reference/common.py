"""Plain PyTorch pieces shared by the references: the Matérn-2.5 kernel and
its derivative, the parameter maps, AdamW and the learning-rate schedule
of the training loop.

Nothing here imports the program under test. Each function follows the
published mathematics (Rasmussen & Williams 2006, eq. 4.17, for the kernel;
Loshchilov & Hutter 2019 for AdamW) and reads only tensors that the
benchmark made.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

SQRT5 = math.sqrt(5.0)


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products in true fp32 (the references) or in TF32 (the
    controls); the previous setting is restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def softplus(x):
    return torch.nn.functional.softplus(x, beta=1.0, threshold=50.0)


def sqdist(a, b):
    """|a_i − b_j|², (n, m), for inputs already divided by the lengthscale;
    the expansion, clamped at 0."""
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    return d2.clamp_min(0.0)


def matern25(d2):
    """k(r) = (1 + √5 r + 5/3 r²) exp(−√5 r), r² = d2 (r floored at 1e-15,
    so that the gradient stays finite at r = 0)."""
    r = torch.sqrt(d2.clamp_min(1e-30))
    return (1.0 + SQRT5 * r + (5.0 / 3.0) * d2) * torch.exp(-SQRT5 * r)


def matern25_dd2(d2):
    """dk/d(r²) = −(5/6)(1 + √5 r) exp(−√5 r)."""
    r = torch.sqrt(d2.clamp_min(0.0))
    return (-5.0 / 6.0) * (1.0 + SQRT5 * r) * torch.exp(-SQRT5 * r)


def kernel(x1, x2, ls):
    """Matérn-2.5 cross-covariance of one latent, (n, m), ls (d,). Inputs
    are centred on x1's mean first (the kernel is translation invariant)."""
    mu = x1.mean(0)
    return matern25(sqdist((x1 - mu) / ls, (x2 - mu) / ls))


def lengthscale_grad(xc, ls, dK):
    """∂/∂l_d of Σ_ij dK_ij k(x_i, x_j) for one latent on centred inputs xc
    (n, d), dK (n, n) symmetric: −2/l_d³ Σ_ij G_ij (x_id − x_jd)² with
    G = dK ⊙ k′(r²), the sum expanded into row sums and one product, in
    float64."""
    a = xc / ls
    G = (dK * matern25_dd2(sqdist(a, a))).double()
    x = xc.double()
    rows = G.sum(1)
    sq = 2.0 * (rows @ (x * x)) - 2.0 * ((G @ x) * x).sum(0)
    return (-2.0 * sq / ls.double() ** 3).to(xc.dtype)


def lambda_lr(i: int, lr_max: float, lr_min: float, last: int = 10000):
    """Linear decay lr_max → lr_min over ``last`` steps, then flat, in
    float32 (the training loop's LambdaLR)."""
    f = np.float32
    i_ = f(i)
    frac = i_ / f(last) * f(lr_min / lr_max) + (f(last) - i_) / f(last)
    scale = frac if i <= last else f(lr_min / lr_max)
    return float(f(lr_max) * f(scale))


class AdamW:
    """Decoupled weight decay Adam over a dict of leaves, updated in place:
    p ← p(1 − lr·wd); m, v the moment averages; p ← p − lr·m̂/(√v̂ + ε)."""

    def __init__(self, leaves: dict, weight_decay=1e-2, betas=(0.9, 0.999),
                 eps=1e-8):
        self.leaves = leaves
        self.wd, (self.b1, self.b2), self.eps = weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    def step(self, grads: dict, lr: float):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.leaves.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train_steps(leaves: dict, loss_and_grads, steps: int, lr: float,
                weight_decay: float):
    """Run ``steps`` AdamW steps of −loss from ``leaves`` (copied); returns
    (losses, first gradients, leaves after the steps).
    ``loss_and_grads(leaves, i)`` gives (loss, {name: ∂loss/∂leaf}) of the
    minimised objective at step i."""
    leaves = {k: v.clone() for k, v in leaves.items()}
    opt = AdamW(leaves, weight_decay)
    losses, first = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(leaves, i)
        losses.append(float(loss))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(grads, lambda_lr(i, lr, lr / 10.0))
    return losses, first, leaves
