"""The collectives of the parallel modes, over ``torch.distributed``.

Counterpart of the ``jax.lax.psum`` / ``pmean`` / ``pmax`` /
``ppermute`` calls that ``wcmc_tpu``'s parallel modes make inside a
sharded computation.  Every helper takes a process group, and on a group
of ``None`` (one rank: nothing to combine) returns its input as it is,
so a model with ``sample_group=None`` runs exactly its single-device
code.

Only two collectives are used: all-reduce, and broadcast (in
``mesh.replicate``).  They are the two that the gloo backend runs on
CUDA tensors (``torch.distributed``'s backend table), so every mode runs
with ranks that share one card over gloo as well as over NCCL.  A gather
is an all-reduce of zero-filled slots, each rank filling its own (adding
zeros is exact, so every rank holds the same bits).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, as a new tensor
    (forward only: no gradient flows through it)."""
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (the sum over the
    ranks, then one division, as ``jax.lax.pmean``)."""
    if group is None:
        return x
    return all_sum(x, group) / group_size(group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``group``."""
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, r, k = group_size(group), group_rank(group), x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * k
        out = x.new_zeros(shape)
        out.narrow(dim, r * k, k).copy_(x)
        dist.all_reduce(out, group=group)
        ctx.group_n, ctx.at, ctx.k, ctx.dim = n, r * k, k, dim
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at, ctx.k) * ctx.group_n, None, None


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    the group's rank order, on every rank.

    Differentiable for a loss that every rank of ``group`` computes alike
    from the gathered tensor, with the gradients then averaged over the
    ranks (``mesh.data_parallel_step``): the backward returns this rank's
    slice of the cotangent times the group's size, which is what the sum
    over the ranks of their identical cotangents would hand this rank,
    without a collective in the backward."""
    if group is None:
        return x
    return _GatherCat.apply(x, group, dim % x.dim())
