"""The ('data', 'latent') mesh of the port, and the model sharding rules
(port of ``projected_lmc_tpu/parallel/mesh.py``).

Two axes, as in the JAX package:

  * ``latent``: the q-batch of latent GPs. Each rank of a latent group
    factorizes its own latents (kernel K3 and one batched Cholesky on its
    (q/L, n, n) block).
  * ``data``: rows of the training set. On the SGPR route and in the
    variational ELBO each rank of a data group builds its rows' K_xz with
    K3 and the Gram and row sums are summed over the group. In the LMC's
    matrix-free solvers a rank holds the rows r0..r1 − 1 of its latents'
    kernel stack, (q/L, n/D, n) (:class:`RowBlock`), and every product of
    the stack is one sum over the world of the ranks' zero-padded rows.
    The ICM has one kernel, so its rows split over ALL ranks of the mesh,
    (n/(D·L), n) a rank.

The JAX package places the leaves (:func:`model_shardings`) and lets XLA
partition the computation. PyTorch has no partitioner, so here the mesh is
attached to the model (:func:`shard_model`) and the model's own methods
compute the rank's terms and the group sums (``parallel.sharded`` states
the rule). The ranks form the grid ``reshape(data, latent)`` in rank order,
as JAX's ``make_mesh`` lays out devices: rank = d·L + l.

A :class:`Mesh` built with no process group (no
``distributed.initialize``) is a layout: :func:`sharding_report` reads it,
and a collective on one of its axes raises unless the axis has one rank.
"""

from __future__ import annotations

import re

import torch

from ..module import keyed_state
from ..utils.profiling import count
from . import collectives as col

_LATENT_SCOPES = ("covar_module", "likelihood", "train_y", "var_mean",
                  "var_chol", "lmc_coeffs", "mean_module")


class Mesh:
    """Axis sizes ``shape = {"data": D, "latent": L}``, this rank's place in
    the grid (``data_index``, ``latent_index``), its latent and data process
    groups, and its device. ``groups`` is None for a layout."""

    axis_names = ("data", "latent")

    def __init__(self, data: int, latent: int, rank: int = 0, groups=None,
                 device=None):
        self.shape = {"data": int(data), "latent": int(latent)}
        self.size = self.shape["data"] * self.shape["latent"]
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = int(rank)
        self.data_index, self.latent_index = divmod(self.rank, int(latent))
        self._groups = groups
        self.device = device

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, latent="
                f"{self.shape['latent']}, rank={self.rank}, "
                f"{'initialized' if self._groups else 'layout'})")

    def group(self, axis: str):
        """The process group of ``axis`` ("data", "latent" or "world"), or
        None for an axis of one rank in a layout."""
        if self._groups is not None:
            return self._groups[axis]
        if (self.size if axis == "world" else self.shape[axis]) == 1:
            return None
        raise RuntimeError(
            f"this Mesh is a layout with no process group, and its {axis} "
            f"axis has more than one rank: call parallel.initialize() and "
            f"build the mesh with make_mesh or make_global_mesh")

    @staticmethod
    def _range(count: int, parts: int, index: int):
        return index * count // parts, (index + 1) * count // parts

    def latent_range(self, q: int):
        """(lo, hi): this rank's latents lo..hi − 1 of q."""
        return self._range(q, self.shape["latent"], self.latent_index)

    def data_range(self, n: int):
        """(lo, hi): this rank's rows lo..hi − 1 of n."""
        return self._range(n, self.shape["data"], self.data_index)

    def world_range(self, n: int):
        """(lo, hi): this rank's rows lo..hi − 1 of n split over every rank
        of the mesh in rank order (the ICM's rows, the test points of a
        sharded posterior)."""
        return self._range(n, self.size, self.rank)

    def row_block(self, n: int, q: int = 1, over: str = "data"):
        """This rank's :class:`RowBlock` of a (q, n, n) stack: its latents
        and its rows over the data axis (``over="data"``, the LMC), or one
        kernel's rows over every rank (``over="world"``, the ICM)."""
        return RowBlock(self, n, q, over)

    def world_sum_(self, x):
        """``x`` replaced in place by its sum over every rank, outside
        autograd (a zero-padded buffer into which each rank wrote its rows
        and latents: one call sums both). Returns ``x``."""
        g = self.group("world")
        return x if g is None else col.sum_(x, g)

    def world_max_(self, x):
        """``x`` replaced in place by its elementwise max over every rank,
        outside autograd. Returns ``x``."""
        g = self.group("world")
        return x if g is None else col.max_(x, g)

    def world_sum(self, x):
        """Σ over every rank, differentiable (its backward sums the
        gradient over every rank): the partial sums of a model whose rows
        split over the whole world."""
        g = self.group("world")
        return x if g is None else col.group_sum(x, g)

    def world_any(self, flag) -> bool:
        """True if ``flag`` holds on any rank of the mesh."""
        g = self.group("world")
        if g is not None:
            return col.any_of(flag, g)
        count("host_read")
        return bool(flag)

    def gather_world(self, x, lo: int, hi: int, total: int, dim: int = 0):
        """The whole of a tensor whose rows lo..hi − 1 along ``dim`` this
        rank holds and the other ranks the rest (:meth:`world_range`),
        differentiable."""
        g = self.group("world")
        return x if g is None else col.gather(x, lo, hi, total, g, dim)

    def latent_sum(self, x):
        """Σ over the latent group, differentiable."""
        g = self.group("latent")
        return x if g is None else col.group_sum(x, g)

    def data_sum(self, x):
        """Σ over the data group, differentiable."""
        g = self.group("data")
        return x if g is None else col.group_sum(x, g)

    def gather_latents(self, x, lo: int, hi: int, q: int, dim: int = 0):
        """The whole q-batch from this rank's latents lo..hi − 1 along
        ``dim``, differentiable."""
        g = self.group("latent")
        return x if g is None else col.gather(x, lo, hi, q, g, dim)

    def block(self, x, index):
        """``x[index]``, this rank's block of a tensor every rank computes
        whole, whose backward hands every rank the whole gradient
        (``collectives.block`` over all ranks)."""
        g = self.group("world")
        return x[index] if g is None else col.block(x, index, g, self.size)

    def latent_any(self, flag) -> bool:
        """True if ``flag`` holds on any rank of the latent group."""
        g = self.group("latent")
        if g is not None:
            return col.any_of(flag, g)
        count("host_read")
        return bool(flag)

    def broadcast_(self, tensors):
        """Rank 0's values into every rank's ``tensors``, in place."""
        if self.group("world") is not None:
            col.broadcast_(list(tensors), self.group("world"))

    def average_(self, tensors):
        """Each tensor replaced by its mean over all ranks, in place."""
        if self.group("world") is not None:
            col.average_(list(tensors), self.group("world"))


class RowBlock:
    """A rank's part of a (q, n, n) kernel stack under a mesh: latents
    lo..hi − 1 of q and rows r0..r1 − 1 of n, the stack's block
    (hi − lo, r1 − r0, n). The LMC's rows split over the data axis and its
    latents over the latent axis; the ICM's one kernel (q = 1) splits its
    rows over every rank.

    The solvers keep their state (the CG vectors, the preconditioner) whole
    and the same on every rank; only the stack and its products are split.
    :meth:`sum_rows`, :meth:`gather_product` and the gathers are the one
    collective of a product: the rank's rows written into a zero buffer,
    summed over the world in place, outside autograd (the ops write their
    own backward). A product is gathered before any sum over the latents
    or tasks, so that every rank finishes it in one process's order and
    the replicated state stays what one process computes.
    ``grad_scale`` is the world size: the factor by which an op scales the
    cotangent of the rank's block, the adjoint of its forward's world sum
    under ``parallel.sharded``'s rule (the gradients averaged over the
    ranks then give the sum of the blocks' terms)."""

    def __init__(self, mesh: "Mesh", n: int, q: int = 1, over: str = "data"):
        self.mesh, self.n, self.q = mesh, int(n), int(q)
        if over == "data":
            self.lo, self.hi = mesh.latent_range(self.q)
            self.r0, self.r1 = mesh.data_range(self.n)
            self.owns_rows = mesh.latent_index == 0
        elif over == "world":
            self.lo, self.hi = 0, self.q
            self.r0, self.r1 = mesh.world_range(self.n)
            self.owns_rows = True
        else:
            raise ValueError(f"a row block is over 'data' or 'world', not "
                             f"{over!r}")
        self.grad_scale = mesh.size

    def sum_rows(self, part):
        """(..., n, C): the rank's rows (..., r1 − r0, C) placed at r0..r1 − 1
        of a zero buffer, summed over the world (over the latents' ranks
        and the rows' ranks in one call)."""
        full = part.new_zeros(part.shape[:-2] + (self.n, part.shape[-1]))
        full[..., self.r0:self.r1, :] = part
        return self.mesh.world_sum_(full)

    def gather(self, part):
        """(q, n, ...): the rank's (hi − lo, r1 − r0, ...) block of a
        latent-batched tensor, gathered whole on every rank."""
        full = part.new_zeros((self.q, self.n) + tuple(part.shape[2:]))
        full[self.lo:self.hi, self.r0:self.r1] = part
        return self.mesh.world_sum_(full)

    def gather_product(self, part):
        """(..., n, q): the rank's rows and latents (..., r1 − r0, hi − lo)
        of a product of the stack, gathered whole on every rank (before any
        sum over the latents, which every rank then takes in one process's
        order)."""
        full = part.new_zeros(part.shape[:-2] + (self.n, self.q))
        full[..., self.r0:self.r1, self.lo:self.hi] = part
        return self.mesh.world_sum_(full)

    def gather_rows(self, part):
        """(q, n, ...): the rank's rows (q, r1 − r0, ...) for ALL q latents,
        gathered whole; of the ranks that hold the same rows (a latent
        group, on the data axis) only the group's first writes them."""
        full = part.new_zeros((part.shape[0], self.n) + tuple(part.shape[2:]))
        if self.owns_rows:
            full[:, self.r0:self.r1] = part
        return self.mesh.world_sum_(full)


def make_mesh(n_devices: int = None, latent: int = None,
              data: int = None) -> Mesh:
    """A ('data', 'latent') mesh over the world's ranks (1 without a process
    group). Axis sizes when not given, as JAX's: latent 2 when the count is
    even, else 1, the rest to data. Under a process group every rank must
    call it: it builds the groups (``torch.distributed.new_group``). With
    no process group it is a layout of rank 0."""
    import torch.distributed as dist

    from . import distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if latent is None and data is None:
        latent = 2 if n_devices % 2 == 0 else 1
        data = n_devices // latent
    elif latent is None:
        latent = n_devices // data
    elif data is None:
        data = n_devices // latent
    if latent * data != n_devices:
        raise AssertionError("mesh axes must multiply to n_devices")
    if not dist.is_initialized():
        return Mesh(data, latent)
    if n_devices != world:
        raise ValueError(f"a mesh spans every rank: {n_devices} devices "
                         f"asked for in a world of {world}")
    return Mesh(data, latent, dist.get_rank(), _new_groups(data, latent),
                distributed.current_device())


def _new_groups(data: int, latent: int) -> dict:
    """This rank's latent group (its row of the grid), data group (its
    column) and the world; every rank creates every group, in one order."""
    import torch.distributed as dist

    from . import distributed
    rank, timeout = dist.get_rank(), distributed.collective_timeout()
    groups = {"world": dist.group.WORLD}
    rows = [[d * latent + i for i in range(latent)] for d in range(data)]
    cols = [[d * latent + i for d in range(data)] for i in range(latent)]
    for axis, members in (("latent", rows), ("data", cols)):
        for ranks in members:
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[axis] = g
    return groups


def _names(key: str):
    """JAX's ``_path_names``: the attribute names of a key path, its index
    steps dropped (``.covar_module.kernels[0].raw_outputscale`` →
    covar_module, kernels, raw_outputscale)."""
    return re.sub(r"\[\d+\]", "", key).split(".")[1:]


def _jax_order(key: str):
    """Sort key giving JAX's leaf order: attributes by name, list items by
    index."""
    return tuple((0, int(t)) if t.isdigit() else (1, t)
                 for t in re.split(r"[.\[\]]+", key) if t)


def _spec_for(names, leaf, q, data_ax, latent_ax):
    """(spec, rule tag) for one leaf, as JAX's ``_spec_for``: the spec a
    tuple equal to JAX's ``PartitionSpec`` entries."""
    if leaf.dim() == 0:
        return (), "scalar"
    if "train_x" in names or "train_y_tasks" in names:
        if leaf.shape[0] % data_ax == 0:
            return ("data",) + (None,) * (leaf.dim() - 1), "data-rows"
        return (), "data-rows-indivisible"
    if any(n in _LATENT_SCOPES for n in names) and q is not None \
            and leaf.shape[0] == q and q % latent_ax == 0:
        if "train_y" in names and leaf.dim() == 2 \
                and leaf.shape[1] % data_ax == 0:
            return ("latent", "data"), "latent-by-data"
        return ("latent",) + (None,) * (leaf.dim() - 1), "latent-batch"
    return (), "replicated"


def _n_latents(model, n_latents):
    if n_latents is not None:
        return n_latents
    return getattr(model, "n_latents", getattr(model, "n_funcs", None))


def sharding_report(model, mesh: Mesh, n_latents: int = None) -> dict:
    """{path: (spec, rule)} for every leaf, the path JAX's ("covar_module.
    raw_lengthscale", index steps dropped). A pure function of the leaves
    and the axis sizes: equal to the JAX package's for the same model."""
    q = _n_latents(model, n_latents)
    data_ax, latent_ax = mesh.shape["data"], mesh.shape["latent"]
    state = keyed_state(model)
    out = {}
    for key in sorted(state, key=_jax_order):
        names = _names(key)
        out[".".join(names)] = _spec_for(names, state[key], q, data_ax,
                                         latent_ax)
    return out


def model_shardings(model, mesh: Mesh, n_latents: int = None) -> dict:
    """{JAX key path: spec} for every leaf (the placement that
    :func:`sharding_report` audits)."""
    q = _n_latents(model, n_latents)
    data_ax, latent_ax = mesh.shape["data"], mesh.shape["latent"]
    return {k: _spec_for(_names(k), t, q, data_ax, latent_ax)[0]
            for k, t in keyed_state(model).items()}


def shard_model(model, mesh: Mesh, n_latents: int = None):
    """Put ``model`` on ``mesh``, in place: rank 0's parameters and buffers
    broadcast to every rank, and the mesh attached, so that the model's
    methods compute this rank's terms and the group sums
    (``projected_lmc_mll(model)`` is then the full MLL on every rank).
    Returns ``model``.

    Takes ``ExactGPModel`` (``ProjectedGPModel`` with it),
    ``VariationalMultitaskGPModel`` and ``MultitaskGPModel``, and every
    route of each runs under the mesh (the models' docstrings say how each
    is split):

      * latents over the latent axis: the dense batched Cholesky and the
        projected model, each rank factorizing its latents;
      * rows over the data axis: ``ExactGPModel``'s SGPR and the ELBO, the
        Gram and row sums summed over the data group;
      * a row block of the stack (its latents' rows over the data axis;
        the ICM's one kernel over every rank), every product one world sum
        of zero-padded rows, the solver's state replicated: the LMC's fused
        PCG (bf16, fp32 or int8 stack; each backward route's kernel in its
        row-block form), its composed PCG and CG + SLQ, the ICM's
        matrix-free PCG, ``ExactGPModel``'s fused and composed iterative
        MLLs, and the "lmc_iter" and "icm_iter" caches;
      * rows over every rank: the LMC's and ICM's SGPR MLL and "sgpr"
        cache (the capacitance couples the latents);
      * whole on every rank: the dense Woodbury LMC (q·n ≤
        ``DENSE_QN_MAX``) and its "lmc" cache, the "icm" cache's n×n eigh
        (the dense ICM MLL splits its t Cholesky blocks over the ranks);
      * test points over every rank: every posterior."""
    from ..models.exact import ExactGPModel
    from ..models.multitask import MultitaskGPModel
    from ..models.variational import VariationalMultitaskGPModel
    if not isinstance(model, (ExactGPModel, VariationalMultitaskGPModel,
                              MultitaskGPModel)):
        raise TypeError(f"shard_model takes an ExactGPModel, a "
                        f"ProjectedGPModel, a MultitaskGPModel or a "
                        f"VariationalMultitaskGPModel, not "
                        f"{type(model).__name__}")
    q = _n_latents(model, n_latents)
    # the ICM's one kernel splits by rows over every rank: no latent batch
    icm = isinstance(model, MultitaskGPModel) and model.icm
    if not icm and q < mesh.shape["latent"]:
        raise ValueError(f"{q} latents cannot cover a latent axis of "
                         f"{mesh.shape['latent']}")
    tensors = list(model.parameters()) + list(model.buffers())
    if mesh.device is not None and any(
            t.device.type != torch.device(mesh.device).type for t in tensors):
        raise ValueError(f"the model's tensors are not on the mesh's device "
                         f"{mesh.device}")
    mesh.broadcast_(tensors)
    model.mesh = mesh
    return model


def replicate(tree, mesh: Mesh):
    """Rank 0's values of ``tree`` (a module, a tensor, or a list or dict of
    tensors) on every rank, in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    mesh.broadcast_(tensors)
    return tree
