"""The serving loop of a cell: a closed loop of one client.
The cache is built once in set-up; each request then asks the fitted
model for the mean and variance at a batch of test points, the sizes
a ladder evenly spread over [batch_min, batch_max] in an order drawn from
the seed (:func:`request_sizes`) and the rows taken
in turn from a pool of test inputs made on the device, and waits until
both are on the host. Set-up warms each size of the ladder once. The window closes with the first request that ends
after ``--seconds``: ``predict_p95_ms`` is the 95th percentile of all its
requests' latencies, ``predict_points_per_s`` its points over its wall
time.

Once the window has closed, ``check_requests`` of its requests drawn from
the seed, the largest among them, are held against the plain reference.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

from . import data
from .compare import serving_numbers
from .trace import Profile
from .train import SetupLog, device_info


def request_sizes(traffic: dict, seed: int, cycles: int = 512):
    """Every seed sends the same sizes in another order: ``ladder`` sizes
    evenly spread over [batch_min, batch_max], each cycle through them in a
    new order drawn from the seed."""
    rng = np.random.default_rng([seed, data.POOL])
    ladder = np.linspace(traffic["batch_min"], traffic["batch_max"],
                         traffic["ladder"]).round().astype(int)
    return np.concatenate([rng.permutation(ladder) for _ in range(cycles)])


def run(cell, pl, seed, seconds, trace, device, t0, variant=None):
    import torch

    cfg, tr, system = cell.config, cell.traffic, cell.system
    log = SetupLog(t0)
    x, y = data.training_set(cfg, seed, device)
    start = system.leaves_from_seed(cfg, seed, device)
    model = system.build(pl, cfg, x, y, start, device)
    prepare, request = system.serving(model)
    if variant is not None:
        request = FAULTS[variant](request)
    pool = data.serving_pool(tr["pool_points"], cfg["d"], seed, device)
    sizes = request_sizes(tr, seed)
    span = tr["pool_points"] - tr["batch_max"]

    def ask(cache, off, size):
        mean, var = request(cache, pool[off:off + size])
        return mean.detach().cpu(), var.detach().cpu()

    log.mark("model built")
    cache = prepare()
    log.mark("cache built")
    for size in sorted(set(sizes[:tr["ladder"]].tolist())):
        ask(cache, 0, int(size))
    setup_s = time.time() - t0
    log.mark("sizes warmed")

    prof = Profile(torch) if trace else None
    if prof is not None:
        prof.start()
    served, lat = [], []
    off, i = 0, 0
    w0 = time.perf_counter()
    prof_end = None
    while True:
        size = int(sizes[i % len(sizes)])
        s0 = time.perf_counter()
        mean, var = ask(cache, off, size)
        s1 = time.perf_counter()
        lat.append(s1 - s0)
        served.append((off, size, mean, var))
        off = (off + size) % span
        i += 1
        if prof is not None and i == tr["profile_requests"]:
            prof.stop()
            prof_end = (time.perf_counter(), i)
        if s1 - w0 >= seconds and (prof is None or prof_end is not None):
            break
    wall = time.perf_counter() - w0
    dev = device_info(torch, device)
    failed = sum(1 for _, _, m, v in served
                 if not (torch.isfinite(m).all() and torch.isfinite(v).all()))
    del cache, model, prepare, request
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng([seed, data.POOL, 1])
    k = min(tr["check_requests"], len(served))
    picks = set(rng.choice(len(served), size=k - 1, replace=False).tolist()) \
        | {max(range(len(served)), key=lambda j: served[j][1])}
    ref = cell.reference.Posterior(x, y, start, cfg)
    pairs = []
    for j in sorted(picks):
        off_j, size_j, mean, var = served[j]
        rm, rv = ref(pool[off_j:off_j + size_j])
        pairs.append((mean, var, rm.cpu(), rv.cpu()))
    numbers = serving_numbers(pairs)

    points = sum(s for _, s, _, _ in served)
    lat_ms = [1e3 * v for v in lat]
    out = dict(numbers=numbers, attempted=len(served), failed=failed,
               device=dev,
               e2e={"predict_p95_ms": statistics.quantiles(lat_ms, n=20)[-1]
                    if len(lat_ms) > 1 else lat_ms[0],
                    "predict_points_per_s": points / wall,
                    "setup_s": setup_s})
    least = [cell.work.least_request_seconds(cfg, s) for _, s, _, _ in served]
    ctx = {"loop": "serve", "least_s": sum(least), "wall_s": wall}
    if prof is not None:
        n_prof = tr["profile_requests"]
        tr_ = prof.read()
        ctx.update(profiled_least_s=sum(least[:n_prof]),
                   busy_s=tr_["busy_s"], window_s=tr_["window_s"],
                   kernels=tr_["kernels"], profiled_requests=n_prof,
                   least_s=sum(least[n_prof:]),
                   wall_s=wall - (prof_end[0] - w0))
        out["device"].update(busy_s=tr_["busy_s"], window_s=tr_["window_s"])
        out["breakdown"] = {"device_ops": tr_["device_ops"],
                            "idle_gaps": tr_["idle_gaps"]}
    out["ctx"] = ctx
    return out


def _altered(request):
    """A planted fault: each answer's first mean altered where produced."""
    def faulty(cache, x_star):
        mean, var = request(cache, x_star)
        mean = mean.clone()
        mean[0] += 0.05 * mean.abs().max()
        return mean, var
    return faulty


def _half(request):
    """A planted fault: half of each batch left out, its answers copied
    from the other half."""
    def faulty(cache, x_star):
        h = (x_star.shape[0] + 1) // 2
        mean, var = request(cache, x_star[:h])
        return (mean.repeat(2, 1)[: x_star.shape[0]],
                var.repeat(2, 1)[: x_star.shape[0]])
    return faulty


FAULTS = {"altered": _altered, "half": _half}
