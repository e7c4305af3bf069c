"""Inputs made from the seed on the device, in a few large calls: the
training set and the serving pool. The same seed gives the same tensors,
and both the program and the reference receive them."""

from __future__ import annotations

import math

import torch

# sub-streams of one seed, so that each draw stays fixed when another changes
DATA, LEAVES, PROBES, POOL = 0, 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one sub-stream of ``seed`` (any whole
    number below 2**62)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) % (2 ** 63))


def training_set(cfg: dict, seed: int, device):
    """x (n, d) ~ N(0, 1) and y = sin(1.5 x W/√d) A + 0.3 ε, (n, T)."""
    n, d, t, q = cfg["n"], cfg["d"], cfg["T"], cfg["q"]
    g = generator(seed, DATA, device)
    draw = dict(generator=g, device=device, dtype=torch.float32)
    x = torch.randn((n, d), **draw)
    W = torch.randn((d, q), **draw)
    A = torch.randn((q, t), **draw)
    y = torch.sin(1.5 / math.sqrt(d) * (x @ W)) @ A \
        + 0.3 * torch.randn((n, t), **draw)
    return x, y


def serving_pool(points: int, d: int, seed: int, device):
    """The test inputs every request takes its rows from, (points, d)."""
    return torch.randn((points, d), generator=generator(seed, POOL, device),
                       device=device, dtype=torch.float32)


def uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float32)


def inv_softplus(y):
    return y + torch.log(-torch.expm1(-y))


def lengthscale_leaf(cfg, g, device):
    """raw lengthscales (q, 1, d) for √(d/4)·exp(U(−0.2, 0.2))."""
    q, d = cfg["q"], cfg["d"]
    ls = math.sqrt(d / 4.0) * torch.exp(uniform(g, (q, 1, d), -0.2, 0.2,
                                                device))
    return inv_softplus(ls)
