"""The collectives of the port's mesh, on ``torch.distributed``.

The port issues three collectives only: ``all_reduce`` (a sum, or a max
for the int8 scales of a row-sharded stack), ``broadcast`` and
``barrier``. They are what gloo takes on CUDA tensors (it has no
``all_gather`` or ``reduce_scatter`` there), so the same code runs over
gloo with ranks sharing one card, over NCCL with a card a rank, and over
gloo on the CPU. A gather is a sum of zero-filled buffers into which each
rank wrote its own slice (:func:`gather`).

:func:`group_sum` is the sum over a process group as an autograd function:
its backward is again a sum of the incoming gradient over the group, as
``torch.distributed.nn.functional.all_reduce`` does. ``parallel.sharded``
states the rule that makes that the right gradient.

Every rank of a group must issue the group's collectives in the same order.
In a forward that holds by construction (the ranks run the same code). In
a backward the autograd engine may order independent nodes as it likes,
so a model packs the sums of one stage into one tensor and one call: the
backward's collectives then lie on one chain of dependencies, and their
order is forced.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import count


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_sum(x, group):
    """Σ over the ranks of ``group`` of ``x``, differentiable (the
    backward sums the gradient over the group)."""
    return _GroupSum.apply(x, group)


def gather(x, lo: int, hi: int, total: int, group, dim: int = 0):
    """The whole of a tensor whose rows ``lo:hi`` along ``dim`` this rank
    holds (``x``) and the other ranks of ``group`` the rest: the sum over
    the group of zero-filled buffers of size ``total`` along ``dim``,
    differentiable."""
    dim = dim % x.dim()
    pad = [0, 0] * (x.dim() - 1 - dim) + [lo, total - hi]
    return group_sum(torch.nn.functional.pad(x, pad), group)


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, group, size):
        ctx.index, ctx.group, ctx.size, ctx.shape = index, group, size, \
            x.shape
        return x[index].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.index] = g
        dist.all_reduce(full, group=ctx.group)
        return full / ctx.size, None, None, None


def block(x, index, group, size: int):
    """``x[index]``: this rank's block of a tensor that every rank of
    ``group`` (``size`` ranks) computes whole. Its backward sums the
    zero-padded blocks' gradients over the group and divides by ``size``,
    so that each rank carries the whole gradient back into the computation
    it shares with the others, as one process would."""
    return _Block.apply(x, index, group, size)


def sum_(x, group):
    """``x`` replaced in place by its sum over ``group``, outside autograd:
    the products of a row-sharded solver, whose adjoint its op writes
    itself. Returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


def max_(x, group):
    """``x`` replaced in place by its elementwise max over ``group``,
    outside autograd (the absmax of a stack whose blocks the ranks hold).
    Returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def any_of(flag, group) -> bool:
    """True if ``flag`` (a bool tensor) is true on any rank of ``group``."""
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, group=group)
    count("host_read")
    return bool(t.item() > 0)


def broadcast_(tensors, group=None):
    """Overwrite each tensor with rank 0's, in place, in list order."""
    with torch.no_grad():
        for t in tensors:
            if t.numel() == 0:
                continue
            buf = t.detach().contiguous()
            dist.broadcast(buf, src=0, group=group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)


def average_(tensors, group=None):
    """Replace each tensor by its mean over the ranks of ``group``, in
    place, with one ``all_reduce`` of the tensors flattened together (one a
    dtype)."""
    size = dist.get_world_size(group)
    with torch.no_grad():
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault((t.dtype, t.device), []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            flat /= size
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
