"""The training loop of a cell: ``training.fit`` as users run it (AdamW on
the configuration's objective, the losses read once a chunk, the plateau
stop off), one call from the seed's first step to the window's end.

Set-up is everything up to the end of the ``warm_chunks``-th chunk; it
holds the checked steps. The window then runs whole chunks and closes at
the chunk end nearest ``--seconds``: ``train_step_ms`` is its wall time
over its steps. ``fit``'s chunk-end hook (``eval_fn``) marks both ends and
closes the window by raising, so the loop's work is ``fit``'s own.

The checked steps are the first ``checked_steps`` of the run: their losses,
the first gradient as AdamW holds it (its first moment after one step over
1 − β₁) and the leaves after them, against the plain reference from the
same data, leaves and probes.
"""

from __future__ import annotations

import sys
import time

from . import data
from .compare import training_numbers
from .trace import Profile


class WindowClosed(Exception):
    pass


class Recorder:
    """What the objective hands out during the run: the probes of the
    checked steps and every step's loss (on the device, read at the end)."""

    def __init__(self, checked: int):
        self.checked = checked
        self.probe_sets = {}
        self.losses = []

    def probes(self, call, **tensors):
        if call < self.checked:
            self.probe_sets[call] = tuple(t.clone() for t in tensors.values())

    def loss(self, value):
        self.losses.append(value.detach())


class SetupLog:
    """Seconds from the process's start to each stage of set-up, on
    standard error (for the record; not a metric)."""

    def __init__(self, t0):
        self.t0 = t0
        self.mark("harness started")

    def mark(self, stage):
        print(f"setup {stage} {time.time() - self.t0:.3f} s", file=sys.stderr)


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(cell, pl, seed, seconds, trace, device, t0, variant=None):
    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook
    from projected_lmc_tpu_torch.training import fit

    cfg, tr, system = cell.config, cell.traffic, cell.system
    log = SetupLog(t0)
    chunk, warm, checked = tr["scan_steps"], tr["warm_chunks"], \
        tr["checked_steps"]
    x, y = data.training_set(cfg, seed, device)
    start = system.leaves_from_seed(cfg, seed, device)
    model = system.build(pl, cfg, x, y, start, device)
    log.mark("model built")
    rec = Recorder(checked)
    loss_fn = system.objective(pl, cfg, rec, variant)
    names = {p: k for k, p in model.named_parameters() if p.requires_grad}
    captured = {}

    def capture(opt, args, kwargs):
        captured["steps"] = captured.get("steps", 0) + 1
        if captured["steps"] == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            captured["grad"] = {
                names[p]: opt.state[p]["exp_avg"] / (1 - beta1)
                if "exp_avg" in opt.state[p]
                else torch.full_like(p, float("nan")) for p in names}
        if captured["steps"] == checked:
            captured["after"] = {k: p.detach().clone()
                                 for p, k in names.items()}

    prof = Profile(torch) if trace else None
    marks, win = [], {}

    n_prof = tr["profile_chunks"] if trace else 0

    def on_chunk(_, i):
        c = i // chunk
        if c < warm:
            return
        done = c - warm
        if done == n_prof and prof is not None and prof.running:
            prof.stop()
        now = time.perf_counter()
        marks.append(now)
        if done == 0:
            win["setup_s"] = time.time() - t0
            log.mark("warm chunks done")
            if prof is not None:
                prof.start()
        elif done > n_prof and (now - marks[0]) * (1 + 0.5 / done) >= seconds:
            raise WindowClosed

    hook = register_optimizer_step_post_hook(capture)
    opt = cfg["optimizer"]
    try:
        fit(model, loss_fn, n_iter=10 ** 9, lr=opt["lr"],
            weight_decay=opt["weight_decay"], loss_thresh=0.0,
            scan_steps=chunk, seed=(seed * 8 + data.PROBES) % 2 ** 63,
            eval_every=chunk, eval_fn=on_chunk, device=device)
    except WindowClosed:
        pass
    finally:
        hook.remove()
        if prof is not None and prof.running:
            prof.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dev = device_info(torch, device)
    # a step that never reached the optimizer left no first moment, and the
    # leaves as they stand
    captured.setdefault("grad", {k: torch.full_like(p, float("nan"))
                                 for p, k in names.items()})
    captured.setdefault("after", {k: p.detach().clone()
                                  for p, k in names.items()})
    losses = torch.stack(rec.losses).double().cpu()
    steps = (len(marks) - 1) * chunk
    wall = marks[-1] - marks[0]
    window = losses[warm * chunk: warm * chunk + steps]
    failed = int((~torch.isfinite(window)).sum())
    prog_losses = [float(v) for v in losses[:checked]]
    probes = [rec.probe_sets[i] for i in range(checked)] \
        if rec.probe_sets else None
    del model, loss_fn, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_losses, ref_grad, ref_after = reference_steps(
        cell, x, y, start, probes, checked, device)
    numbers = training_numbers(prog_losses, [-v for v in ref_losses], captured["grad"],
                               ref_grad, start, captured["after"], ref_after)
    step_s = wall / steps
    least = cell.work.least_step_seconds(cfg)
    out = dict(numbers=numbers, attempted=steps, failed=failed,
               device=dev,
               e2e={"train_step_ms": 1e3 * step_s,
                    "setup_s": win["setup_s"]})
    ctx = {"loop": "train", "least_s": least, "step_s": step_s,
           "steps": steps}
    if prof is not None:
        tr_ = prof.read()
        ctx.update(profiled_steps=n_prof * chunk, busy_s=tr_["busy_s"],
                   window_s=tr_["window_s"], kernels=tr_["kernels"],
                   step_s=(marks[-1] - marks[n_prof])
                   / ((len(marks) - 1 - n_prof) * chunk))
        out["device"].update(busy_s=tr_["busy_s"], window_s=tr_["window_s"])
        out["breakdown"] = {"device_ops": tr_["device_ops"],
                            "idle_gaps": tr_["idle_gaps"]}
    out["ctx"] = ctx
    return out


def reference_steps(cell, x, y, start, probes, steps, device):
    """The reference's checked steps, true fp32 products, from the same data,
    starting leaves and probes."""
    from reference.common import precision
    with precision(tf32=False):
        if probes is None:
            return cell.reference.train(x, y, start, cell.config, steps)
        frozen = cell.system.frozen_leaves(cell.config, device)
        return cell.reference.train(x, y, start, frozen, probes, cell.config,
                                    steps)
