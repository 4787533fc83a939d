"""Collectives that autograd knows: ``torch.autograd.Function``s over a
:class:`~repro_torch.runtime.process_group.Communicator`.

Each sum is the communicator's rank-ordered one, so every rank holds the
same bits and a rerun replays them (the exact resume needs both).  Sums of
bf16 or fp16 tensors are taken in fp32 and rounded once.

  * :func:`sum_over` — a partial sum leaving a row-parallel product: summed
    over the group; its gradient passes through (every rank holds the
    whole gradient of the sum);
  * :func:`grad_sum_over` — a whole tensor feeding this rank's part of a
    parallel computation: passes through; its gradient, a partial sum, is
    summed over the group;
  * :func:`data_sum` — a sum over the data axis that every rank then uses
    in its own loss (the mesh step adds the ranks' gradients and divides
    by their count): summed over the group, and so is its gradient;
  * :func:`gather` — a stored block made whole along ``dim``; its gradient
    goes back as this rank's block, of the sum over the group where each
    rank's use was a part (``partial``), else as it is;
  * :func:`max_over` — an elementwise max over the group, outside autograd.
"""
from __future__ import annotations

import torch

__all__ = ["sum_over", "grad_sum_over", "data_sum", "gather",
           "max_over"]


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.element_size() < 4 and x.is_floating_point() else x


def _sum(x: torch.Tensor, comm) -> torch.Tensor:
    return comm.all_reduce_sum([_wide(x)])[0].to(x.dtype)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return _sum(x, comm)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.comm), None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _sum(x, comm)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.comm), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, partial):
        ctx.comm, ctx.dim, ctx.partial = comm, dim, partial
        ctx.n = x.shape[dim]
        return comm.gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.comm, ctx.dim
        if ctx.partial:
            out = comm.reduce_scatter_sum(_wide(g), dim).to(g.dtype)
        else:
            out = g.narrow(dim, comm.rank * ctx.n, ctx.n).contiguous()
        return out, None, None, None


def sum_over(x: torch.Tensor, comm) -> torch.Tensor:
    if comm is None or comm.size == 1:
        return x
    return _SumOver.apply(x, comm)


def grad_sum_over(x: torch.Tensor, comm) -> torch.Tensor:
    if comm is None or comm.size == 1:
        return x
    return _GradSumOver.apply(x, comm)


def data_sum(x: torch.Tensor, comm) -> torch.Tensor:
    if comm is None or comm.size == 1:
        return x
    return _DataSum.apply(x, comm)


def gather(x: torch.Tensor, comm, dim: int, partial: bool) -> torch.Tensor:
    if comm is None or comm.size == 1:
        return x
    return _Gather.apply(x, comm, dim, partial)


def max_over(x: torch.Tensor, comm) -> torch.Tensor:
    if comm is None or comm.size == 1:
        return x.detach()
    return comm.all_reduce_max(x.detach())
