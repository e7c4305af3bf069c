"""Run a function on n ranks, one spawned process each.

:func:`run_ranks` starts the ranks with ``multiprocessing``'s ``spawn``
(never ``fork``, which CUDA does not survive), joins them in a process
group over a ``file://`` rendezvous in a fresh directory, runs
``target(rank, *args)`` on each, and returns their results in rank order.
A rank that raises, or exits without a result, fails the whole run: the
others are killed and the failing rank's traceback is raised. Every rank
is joined with a deadline and killed when it passes, so a hung rendezvous
or collective can never outlast ``timeout``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback


def _rank_main(target, rank, world, init_method, device, local_world_size,
               collective_timeout, threads, args, results):
    from . import distributed
    try:
        if threads:
            import torch
            torch.set_num_threads(threads)
        distributed.initialize(init_method, world, rank, device=device,
                               local_world_size=local_world_size,
                               timeout=collective_timeout)
        results.put((rank, True, target(rank, *args)))
    except BaseException:               # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        distributed.shutdown()


def run_ranks(target, world: int, args=(), device="cuda",
              local_world_size: int = None, timeout: float = 600.0,
              collective_timeout: float = 120.0, threads: int = None):
    """[target(rank, *args) for each rank], each rank in its own spawned
    process, in a process group of ``world`` ranks (``parallel.initialize``
    with ``device``, ``local_world_size`` and ``collective_timeout``
    seconds; the ranks all run on this host, so ``local_world_size``
    defaults to ``world``, and a smaller one lays them out as if on several
    hosts). ``target`` and ``args`` are pickled
    (a module-level function); ``threads`` sets each rank's torch threads.
    Raises ``RuntimeError`` with the traceback of the first rank that
    fails, and ``TimeoutError`` when the ranks have not all returned within
    ``timeout`` seconds; either way no rank is left running."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="plmc_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            target, rank, world, init, device, local_world_size or world,
            collective_timeout, threads, tuple(args), results))
            for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} of "
                        f"{world} gave no result within {timeout:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if gone:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code "
                            f"{procs[gone[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                out[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
    return [out[r] for r in range(world)]
