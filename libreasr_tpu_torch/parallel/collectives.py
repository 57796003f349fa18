"""The collectives a mesh step runs, as autograd functions where the
step differentiates through them.

Every rank of a data, model or pipe group computes the same loss from
the same gathered values, so the gradient arriving at a gather is the
same on every rank of its group: a gather's backward keeps this rank's
part and sends nothing. Sums of gradients over the data group happen
once, on the flat gradient (`all_reduce_flat`).
"""

from __future__ import annotations

import torch
from torch import nn


def _dist():
    import torch.distributed as dist

    return dist


def _gather(x: torch.Tensor, group, parts: int, dim: int) -> torch.Tensor:
    bufs = [torch.empty_like(x) for _ in range(parts)]
    _dist().all_gather(bufs, x.contiguous(), group=group)
    return torch.cat(bufs, dim=dim)


class AllReduceSum(torch.autograd.Function):
    """The sum of `x` over `group` on every rank. Each rank's loss reads
    the sum, so the sum's gradient is the sum of every rank's: the
    backward all-reduces it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class GatherRows(torch.autograd.Function):
    """[n, ...] on each of `parts` ranks -> [parts * n, ...] in rank order;
    the backward keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, parts: int, index: int):
        ctx.rows = (index * x.shape[0], x.shape[0])
        return _gather(x, group, parts, 0)

    @staticmethod
    def backward(ctx, g):
        start, n = ctx.rows
        return g.narrow(0, start, n), None, None, None


class GatherColumns(torch.autograd.Function):
    """A column block [..., w] on each of `parts` ranks -> the whole
    [..., parts * w]; the backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, parts: int, index: int):
        ctx.cols = (index * x.shape[-1], x.shape[-1])
        return _gather(x, group, parts, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        start, w = ctx.cols
        return g.narrow(g.dim() - 1, start, w), None, None, None


class ColumnShard(nn.Module):
    """A parametrization (torch.nn.utils.parametrize): the module stores
    its column block of the parameter and reads the whole one, gathered
    over the model group, so kernels see whole weights."""

    def __init__(self, group, parts: int, index: int):
        super().__init__()
        self.group, self.parts, self.index = group, parts, index

    def forward(self, block):
        return GatherColumns.apply(block, self.group, self.parts, self.index)

    def right_inverse(self, whole):
        from .distributed import column_block

        return column_block(whole, self.parts, self.index)


@torch.no_grad()
def all_reduce_flat(tensors: list, group, op=None) -> list:
    """Sum (or `op`) a list of tensors over `group` in one collective on
    their concatenation; returns new tensors of the same shapes."""
    dist = _dist()
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op or dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).clone())
        i += t.numel()
    return out


@torch.no_grad()
def broadcast_flat(tensors: list, src: int, group) -> list:
    """Rank `src`'s values of a list of tensors on every rank of
    `group`, in one collective."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _dist().broadcast(flat, src=src, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).clone())
        i += t.numel()
    return out
