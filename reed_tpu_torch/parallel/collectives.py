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
`sum_over_tensor` sums partials whose total every rank then uses on its
own shard (the RDM's split LayerNorm statistics): each rank's consumer
differs, so its backward sums the ranks' gradients too.

A product split inside one kernel call (ProteinMPNN's message chain,
ops/fused_message.py) returns f32 partials of its outputs and, in its
backward, of its input gradients; `sum_tensor_f32` sums a list of them
over the tensor group in one flat all-reduce, inside that call's
autograd.Function (its forward sums the partial outputs, its backward the
partial input gradients: the adjoint pair of copy_to_tensor and
reduce_from_tensor around the whole chain), so that a bf16 chain rounds
once after the sum.

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

# Bytes all-reduced over the tensor group (copy_to_tensor's backward,
# reduce_from_tensor's forward, sum_tensor_f32) since the count was last set
# to 0; a run reads it to reckon what the tensor axis moves a step.
tensor_bytes = 0


def _tensor_sum(x: torch.Tensor, group) -> torch.Tensor:
    """_all_reduce_f32 over the tensor group, counted in tensor_bytes."""
    global tensor_bytes
    tensor_bytes += x.numel() * 4
    return _all_reduce_f32(x, group)


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
        return _tensor_sum(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _tensor_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _tensor_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _tensor_sum(g, ctx.group), None


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


def sum_over_tensor(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum over the tensor group of the partials x, for consumers that
    differ by rank (the backward sums the gradients over the group)."""
    if dp is None or dp.tensor == 1:
        return x
    return _SumOverTensor.apply(x, dp.tensor_group)


def sum_tensor_f32(parts, dp):
    """The sums over the tensor group of the f32 tensors `parts` (each
    rank's partials), in one flat all-reduce; new tensors in their shapes.
    Not differentiable: the autograd.Function that calls it writes the
    adjoint."""
    if dp is None or dp.tensor == 1:
        return [p.clone() for p in parts]
    if any(p.dtype != torch.float32 for p in parts):
        raise ValueError("sum_tensor_f32 takes f32 partials, got "
                         + ", ".join(str(p.dtype) for p in parts))
    global tensor_bytes
    flat = torch.cat([p.reshape(-1) for p in parts])
    tensor_bytes += flat.numel() * 4
    dist.all_reduce(flat, group=dp.tensor_group)
    return [v.view(p.shape) for v, p in zip(torch.split(flat, [p.numel() for p in parts]),
                                            parts)]


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
