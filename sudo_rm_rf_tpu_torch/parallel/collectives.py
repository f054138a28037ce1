"""The collectives of the (data, model) grid, plain and differentiable.

A group of None is one rank: every collective over it is the identity, so
the one-process mesh never communicates.

gloo's CUDA support covers ``all_reduce`` and ``broadcast``; its
``all_gather`` and ``reduce_scatter`` take CPU tensors. Over gloo a CUDA
tensor is therefore gathered through the host, and a reduce-scatter is an
``all_reduce`` followed by this rank's rows. NCCL runs every collective on
the card. Nothing here picks a backend: the process group's is used.

The differentiable forms follow the usual tensor-parallel rules for a model
group whose ranks hold the same rows and compute the same loss:

* :func:`copy_to_group` (identity forward, ``all_reduce`` backward) where a
  tensor every rank holds whole enters a computation split over the group:
  each rank's gradient is then a part, and the sum is the whole gradient;
* :func:`reduce_from_group` (``all_reduce`` forward, identity backward)
  where the parts of a split computation are summed into a tensor every rank
  holds whole;
* :func:`all_reduce_sum` (``all_reduce`` both ways) for statistics summed
  over the group and used by each rank's part (GlobLN's sums);
* :func:`gather_rows` (``all_gather`` forward, a mean ``reduce_scatter``
  backward) for a param stored as row shards: the forward sees it whole, and
  each rank's shard takes its rows of the gradient, which every rank of the
  group holds whole.
"""

from __future__ import annotations

import torch


def _dist():
    import torch.distributed as dist

    return dist


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else _dist().get_rank(group)


def _gloo(group) -> bool:
    return _dist().get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is not None:
        _dist().all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` laid end to end along dim 0, in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    dist = _dist()
    src = t.contiguous()
    if _gloo(group) and src.is_cuda:
        src = src.cpu()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows (the group rank's 1/n of dim 0) of the sum of ``t``
    over ``group``."""
    n = group_size(group)
    if n == 1:
        return t
    dist = _dist()
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not divide the group of {n}")
    per = t.shape[0] // n
    if _gloo(group):
        total = all_reduce_(t.contiguous().clone(), group)
        r = group_rank(group)
        return total[r * per : (r + 1) * per].clone()
    out = t.new_empty((per, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group) / group_size(ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherRows.apply(x, group)
