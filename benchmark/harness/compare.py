"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's, each held to a limit of its own
(``limits/<workload>.json``)."""

from __future__ import annotations

import math
import statistics

# entries whose reference gradient is below this share of the median
# leaf's root-mean-square entry move by round-off alone under Adam (as the
# last column of a complete QR's input, which only sets a sign): left out
# of the change
TINY_GRADIENT = 1e-3


def _norm(t) -> float:
    return float(t.double().norm())


def leaf_gaps(prog: dict, ref: dict) -> list:
    """|‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖) of each leaf."""
    norms = {k: _norm(r) for k, r in ref.items()}
    med = statistics.median(norms.values())
    return [abs(_norm(prog[k]) - v) / max(v, med, 1e-300)
            for k, v in norms.items()]


def moving_entries(ref_grads: dict) -> dict:
    """{leaf: boolean mask} of the entries that the reference moves by more
    than round-off; leaves with none left out."""
    rms = statistics.median(_norm(g) / math.sqrt(max(g.numel(), 1))
                            for g in ref_grads.values())
    masks = {k: g.double().abs() >= TINY_GRADIENT * rms
             for k, g in ref_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def training_numbers(prog_losses, ref_losses, prog_grad, ref_grad,
                     prog_start, prog_after, ref_after) -> dict:
    """loss_gap: the worst relative gap of the checked steps' losses;
    grad_gap: the worst leaf's gap of first-gradient norms; change_gap: the
    median leaf's gap of the norms of the parameters' change over the
    checked steps (entries that the reference moves only by round-off left
    out). The change is the median leaf's because AdamW's step is nearly
    lr·sign(g) entry by entry: an entry whose gradient lies within its
    leaf's fp32 round-off flips sign from seed to seed, and the worst
    leaf's change swings with it (the projected LMC's H: round-off ~2e-3
    against entries of 1e-3)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-300)
                   for a, b in zip(prog_losses, ref_losses))
    masks = moving_entries(ref_grad)
    d_prog = {k: (prog_after[k].double() - prog_start[k].double())[m]
              for k, m in masks.items()}
    d_ref = {k: (ref_after[k].double() - prog_start[k].double())[m]
             for k, m in masks.items()}
    return dict(loss_gap=loss_gap,
                grad_gap=max(leaf_gaps(prog_grad, ref_grad)),
                change_gap=statistics.median(leaf_gaps(d_prog, d_ref)))


def serving_numbers(pairs) -> dict:
    """pairs: [(prog mean, prog var, ref mean, ref var)] of the checked
    requests. mean_gap / var_gap: the worst request's largest absolute gap
    over its largest reference value."""
    def gap(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-300))
    return dict(mean_gap=max(gap(m, rm) for m, _, rm, _ in pairs),
                var_gap=max(gap(v, rv) for _, v, _, rv in pairs))


def verdict(numbers: dict, limits: dict):
    """(correct, checks) with checks = {name: {value, limit}}; a missing or
    non-finite number fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
