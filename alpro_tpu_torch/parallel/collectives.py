"""The collectives the distributed objectives and steps are built on.

``all_gather_with_grad`` is written out as an ``autograd.Function`` rather
than taken from ``torch.distributed.nn``, whose backward takes another route
on gloo (all-to-all) than on NCCL (reduce-scatter): here both backends run
the same all-reduce. Every function takes a process group, or None for an
axis of one process, where it is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` stacked along dim 0 in rank order, with no
    gradient."""
    if group is None:
        return x
    x = x.detach().contiguous()
    out = x.new_empty((group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    # torch 2.13 renames all_gather_into_tensor (deprecated there) all_gather_single
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


class _AllGatherWithGrad(torch.autograd.Function):
    """Forward: all-gather along dim 0. Backward: the gathered gradient
    summed over the group (every rank's loss reads every rank's rows), then
    this rank's rows of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = group_rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` whose gradient reaches every rank's rows."""
    if group is None:
        return x
    return _AllGatherWithGrad.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, with no gradient (counts and logged
    metrics)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceMean(torch.autograd.Function):
    """Forward: the mean over the group. Backward: the gradient of this
    rank's term of that mean (1/W of the incoming one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = group_size(group)
        return all_reduce_sum(x, group) / ctx.size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


def all_reduce_mean(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The mean of ``x`` over the group (JAX's ``pmean``)."""
    if group is None:
        return x
    return _AllReduceMean.apply(x, group)


def flat_all_reduce_(tensors, group) -> None:
    """Sum each tensor over the group in place, in one flat all-reduce per
    dtype."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        parts = flat.split([t.numel() for t in same])
        torch._foreach_copy_(same, [p.view_as(t) for p, t in zip(parts, same)])
