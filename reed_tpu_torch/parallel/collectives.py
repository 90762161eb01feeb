"""Differentiable collectives of the tensor and seq axes (SiT's Megatron
tensor parallelism and token-sharded sequence parallelism).

The train step takes its gradients with torch.autograd.grad
(core/trainer.py), where no module hook fires, so each collective is a
torch.autograd.Function whose backward is the adjoint of its forward.
`dp` is a parallel.mesh.DataParallel; with dp None, or the axis of size 1,
each function returns its input.

Tensor (Megatron's pair over the tensor group, whose ranks hold one
model's shards and one copy of everything else): `copy_to_tensor` enters a
column-parallel product (identity forward; the backward sums the ranks'
input gradients), `reduce_from_tensor` leaves a row-parallel one (the
forward sums the ranks' partial products; identity backward). The sums run
in f32, so a bf16 activation takes one rounding, as in one process.

Seq (over the seq group, whose ranks hold one model's token slices):
`gather_seq` (all-gather along a dimension; the backward reduce-scatters)
and `sum_seq` (all-reduce; the backward all-reduces). Every seq rank then
computes the whole loss, so the gradient a rank sees is that of the sum of
the S equal losses: S times the loss's gradient on its own tensors, and
its share of S times the loss's on a replicated one. Averaged over the seq
ranks, as the replica group's gradient mean does, that is the loss's
gradient once; a replicated computation after a gather (the pooled
projector) is counted once, not S times.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_LOW = (torch.bfloat16, torch.float16)


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of x, taken in f32 and returned in x's dtype."""
    y = x.float().contiguous() if x.dtype in _LOW else x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in rank order."""
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((size * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's slice along `dim` of the sum over `group` of g, taken in
    f32 and returned in g's dtype."""
    gm = g.movedim(dim, 0)
    gm = (gm.float() if g.dtype in _LOW else gm).contiguous()
    out = gm.new_empty((gm.shape[0] // size,) + tuple(gm.shape[1:]))
    dist.reduce_scatter_tensor(out, gm, group=group)
    return out.to(g.dtype).movedim(0, dim)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = (dim, group, size)
        return _gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _SumSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


def copy_to_tensor(x: torch.Tensor, dp) -> torch.Tensor:
    """x (replicated over the tensor group) into a column-parallel product."""
    if dp is None or dp.tensor == 1:
        return x
    return _CopyToTensor.apply(x, dp.tensor_group)


def reduce_from_tensor(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum over the tensor group of the partial products x."""
    if dp is None or dp.tensor == 1:
        return x
    return _ReduceFromTensor.apply(x, dp.tensor_group)


def gather_seq(x: torch.Tensor, dim: int, dp) -> torch.Tensor:
    """Every seq rank's x along `dim` (its token slices, in seq order)."""
    if dp is None or dp.seq == 1:
        return x
    return _GatherSeq.apply(x, dim, dp.seq_group, dp.seq)


def sum_seq(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum over the seq group of x (each rank's share of a token sum)."""
    if dp is None or dp.seq == 1:
        return x
    return _SumSeq.apply(x, dp.seq_group)
