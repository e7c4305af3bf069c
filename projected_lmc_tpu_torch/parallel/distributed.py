"""Multi-process execution on ``torch.distributed`` (port of
``projected_lmc_tpu/parallel/distributed.py``).

One process a rank. :func:`initialize` joins the process group and picks
the transport: NCCL when every local rank has a card of its own, gloo
when ranks share a card or run on the CPU (``backend=`` overrides). That
is a choice of transport, not a fallback: the tensors and the kernels stay
on the rank's device. :func:`make_global_mesh` lays the ('data', 'latent')
mesh over every process so that a latent group (L consecutive ranks)
stays on one host and the data axis spans hosts.

Typical use, one process a card under ``torchrun``::

    from projected_lmc_tpu_torch import parallel
    parallel.initialize()                        # RANK, WORLD_SIZE, ...
    mesh = parallel.make_global_mesh(latent=2)
    step, model, opt = parallel.sharded_fit_step(model, mesh)

The process group's state is the process's own (``torch.distributed``
keeps it so); this module keeps beside it the rank's device, the number of
ranks on its host and the collectives' timeout.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, _new_groups, make_mesh

# set by initialize(): the rank's device, ranks a host, collective timeout
_context = {}


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, device="cuda", backend: str = None,
               local_world_size: int = None, timeout: float = 300.0) -> bool:
    """Join the process group. Returns True if there is more than one rank,
    False in single-process mode; idempotent once initialized.

    With ``coordinator_address`` ("host:port", or a ``tcp://`` or
    ``file://`` URL) the world is ``num_processes`` ranks of which this is
    ``process_id``, and configuration errors surface. Otherwise torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``env://``)
    is used, and with neither this is single-process mode. Each rank takes
    card ``local_rank % device_count()``; ``device="cpu"`` runs on the CPU
    over gloo, and ``device="cuda"`` without a card raises. ``timeout``
    (seconds) bounds the rendezvous and every collective.

    ``local_world_size`` is the number of ranks on this host. With an
    explicit address it defaults to ``num_processes`` on the CPU, and on
    the card when there are at least as many cards as ranks (one host, a
    card a rank); with more ranks than cards they may share cards or span
    hosts, which nothing here can tell apart, so it must be given."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dev = resolve_device(device)
    if coordinator_address is not None:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        if local_world_size is None and dev.type == "cuda" \
                and world > torch.cuda.device_count():
            raise ValueError(
                f"{world} processes and {torch.cuda.device_count()} cards: "
                f"pass local_world_size, the number of ranks on each host")
        local = int(local_world_size or world)
        local_rank = rank % local
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(local_world_size
                    or os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank % local))
    else:
        return False
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = backend or ("nccl" if local <= cards else "gloo")
    else:
        backend = backend or "gloo"
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=wait)
    _context.update(device=dev, local_world_size=local, timeout=wait)
    return world > 1


def current_device():
    """The device ``initialize`` gave this rank (None before it)."""
    return _context.get("device")


def backend() -> str:
    """The transport of the process group ("nccl" or "gloo"), or None."""
    return dist.get_backend() if dist.is_initialized() else None


def collective_timeout():
    """The timeout ``initialize`` gave the collectives (None before it)."""
    return _context.get("timeout")


def make_global_mesh(latent: int = None, data: int = None) -> Mesh:
    """('data', 'latent') mesh over every process's rank.

    The latent axis is kept within each host's ranks (L consecutive ranks
    of the global order), so a latent group's collectives never leave the
    host; the data axis then spans hosts. Falls back to :func:`make_mesh`
    when there is one process. Every rank must call it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(latent=latent, data=data)
    n = dist.get_world_size()
    local = _context.get("local_world_size", n)
    if latent is None:
        latent = 2 if local % 2 == 0 else 1
    if latent > local or local % latent != 0:
        raise ValueError(f"latent axis ({latent}) must divide the per-host "
                         f"device count ({local}) to stay inside a host")
    if data is None:
        data = n // latent
    if latent * data != n:
        raise ValueError("mesh axes must multiply to the global device count")
    return Mesh(data, latent, dist.get_rank(), _new_groups(data, latent),
                current_device())


def is_coordinator() -> bool:
    """True on the process that should write checkpoints and CSVs: rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown():
    """Leave the process group (every rank calls it at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _context.clear()
