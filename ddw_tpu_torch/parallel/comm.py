"""Differentiable collectives for the parallel layers of the port.

``ddw_tpu`` differentiates through ``ppermute``, ``all_to_all`` and the
GSPMD collectives for free; the port's steps run eagerly in one process per
rank, so each collective that sits on a gradient path is an autograd
``Function`` whose backward is the transpose exchange:

- :func:`ring_shift_grad`: ``i -> i+1`` forward, the cotangent ``i -> i-1``
  backward (ring attention's K/V hop);
- :func:`all_to_all_grad`: the equal-split ``all_to_all_single`` forward
  and the same exchange backward, which is its own inverse (the MoE token
  dispatch);
- :func:`copy_to_group` / :func:`reduce_from_group`: Megatron's *f* and *g*
  (identity forward with an all-reduced gradient; all-reduce forward with
  an identity gradient) over the tensor-parallel group;
- :func:`gather_from_group`: an all-gather along a dim whose backward takes
  this rank's slice (a vocab-parallel head);
- :func:`all_reduce_sum_grad`: a sum over the group whose backward sums the
  cotangents too — every rank's loss reads the sum (the global batch
  moments of a sharded step's BatchNorm).

Each runs the operation of :mod:`ddw_tpu_torch.runtime.collectives` or
:mod:`ddw_tpu_torch.ops.ring_reduce` (the hop, host-staged over gloo) on
the tensor's device; gloo's all-reduce, all-gather and all-to-all take
CUDA tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ddw_tpu_torch.ops.ring_reduce import group_size_rank, ring_shift
from ddw_tpu_torch.runtime.collectives import all_gather_axis, all_reduce_sum


def _size(group) -> int:
    return group_size_rank(group)[0]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return ring_shift(t, group)

    @staticmethod
    def backward(ctx, g):
        # the transpose of i -> i+1: the cotangent goes home, i -> i-1
        return ring_shift(g.contiguous(), ctx.group, -1), None


def ring_shift_grad(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`~ddw_tpu_torch.ops.ring_reduce.ring_shift` by one with its
    transpose as the backward."""
    if _size(group) == 1:
        return t
    return _RingShift.apply(t, group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal split of dim 0: chunk ``j`` goes to group rank ``j``, chunk
    ``i`` of the result came from group rank ``i``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all_grad(t: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1:
        return t
    return _AllToAll.apply(t, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        return all_gather_axis(t, group, tiled=True, axis=dim)

    @staticmethod
    def backward(ctx, g):
        me = group_size_rank(ctx.group)[1]
        return g.narrow(ctx.dim, me * ctx.size, ctx.size), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    return t if _size(group) == 1 else _AllReduceSum.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    return t if _size(group) == 1 else _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    return t if _size(group) == 1 else _ReduceFromGroup.apply(t, group)


def gather_from_group(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    return t if _size(group) == 1 else _GatherFromGroup.apply(t, group, dim)
