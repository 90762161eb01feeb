"""Shared neural-net building blocks (torch.nn), counterparts of
reed_tpu/nn/layers.py with the reference's parameter names.

Projector MLPs, timestep / label embedders, adaLN modulation, the SiT MLP and
fused-qkv attention, NHWC row-major patchify and the fixed 2D sin-cos
position embedding. Layers compute in the dtype of their input: `linear`
casts a weight and bias to it where they are used, as flax's
`Dense(dtype=...)` casts its f32 params, so a model with f32 parameters
(master weights) runs in bf16 from a bf16 input and its gradients land in
f32 on the parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.ops.attention import multi_head_attention
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.collectives import copy_to_tensor, gather_seq, reduce_from_tensor


def linear(x, layer: nn.Linear):
    """`layer(x)` computed in x's dtype: the weight and bias are cast to it
    where they are used (a no-op when they have it already)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def dense(x, layer: nn.Linear, dtype: torch.dtype):
    """flax's Dense(dtype=...): the input, weight and bias in `dtype`."""
    return linear(x.to(dtype), layer)


def layer_norm(x, norm: nn.LayerNorm, dtype: torch.dtype):
    """flax's LayerNorm(dtype=...): f32 statistics and affine, the output in
    `dtype`."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)


class ProjectorMLP(nn.Sequential):
    """3-layer SiLU MLP projecting backbone activations to an encoder's
    representation space (keys 0, 2, 4 as in the reference)."""

    def __init__(self, hidden_size: int, projector_dim: int, z_dim: int):
        super().__init__(
            nn.Linear(hidden_size, projector_dim), nn.SiLU(),
            nn.Linear(projector_dim, projector_dim), nn.SiLU(),
            nn.Linear(projector_dim, z_dim))

    def forward(self, x):
        x = F.silu(linear(x, self[0]))
        x = F.silu(linear(x, self[2]))
        return linear(x, self[4])


def modulate(x, shift, scale):
    """adaLN modulation; shift/scale: [B, D], x: [B, T, D]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings of (fractional) timesteps, f32, order
    [cos, sin]; t: [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            nn.Linear(frequency_embedding_size, hidden_size), nn.SiLU(),
            nn.Linear(hidden_size, hidden_size))

    def forward(self, t, dtype: torch.dtype):
        """t: [B] -> [B, hidden] in `dtype` (the f32 sinusoids cast to it)."""
        x = timestep_embedding(t, self.frequency_embedding_size).to(dtype)
        return linear(F.silu(linear(x, self.mlp[0])), self.mlp[2])


class LabelEmbedder(nn.Module):
    """Class-label embedding; with dropout_prob > 0 the table has a trailing
    null (CFG) class at index num_classes, and in training each label is
    replaced by it with probability dropout_prob (classifier-free guidance
    dropout, flax's rule in reed_tpu)."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_prob = dropout_prob
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, y, dtype: torch.dtype, train: bool = False, drop=None,
                generator: Optional[torch.Generator] = None):
        """y: [B] int labels -> [B, hidden] in `dtype`. With train and
        dropout_prob > 0, the labels where `drop` (bool [B]) is True become
        the null class; without `drop` it is drawn Bernoulli(dropout_prob)
        from `generator`. Outside training nothing is dropped."""
        if train and self.dropout_prob > 0:
            if drop is None:
                drop = draws.rand(y.shape, generator=generator,
                                  device=y.device) < self.dropout_prob
            y = torch.where(torch.as_tensor(drop, device=y.device),
                            self.num_classes, y)
        return F.embedding(y, self.embedding_table.weight.to(dtype))


class _F32Product(torch.autograd.Function):
    """x @ w.T with the product kept in f32 (x and w in one dtype): in bf16
    the products of bf16 values summed in f32, as a bf16 GEMM does before it
    rounds its output (torch.mm's out_dtype on CUDA; on the CPU the f32
    product of the upcast operands, which is exact). The backward is a bf16
    linear layer's: the output gradient (bf16 values) in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            out = x2 @ w.t()
        elif x.is_cuda:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float().t()
        return out.reshape(x.shape[:-1] + (w.shape[0],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        return (g2 @ w).reshape(x.shape), g2.t() @ x.reshape(-1, x.shape[-1])


def tensor_size(parallel) -> int:
    """The tensor axis' size of `parallel` (a parallel.mesh.DataParallel;
    1 where there is none)."""
    return 1 if parallel is None else parallel.tensor


def split_width(width: int, tensor: int, what: str) -> int:
    """A tensor rank's share of `width` units; ValueError where tensor does
    not divide them."""
    if width % tensor:
        raise ValueError(f"tensor={tensor} does not divide {what}'s {width} units")
    return width // tensor


def row_dense(x, layer: nn.Linear, dtype: torch.dtype, parallel):
    """dense(x, layer, dtype), where under the tensor axis of `parallel`
    `layer` holds a rank's input rows: then row_parallel, its f32 partials
    summed over the tensor group before the bias is added once."""
    if tensor_size(parallel) == 1:
        return dense(x, layer, dtype)
    return row_parallel(x.to(dtype), layer, parallel)


def split_layer_norm(x, weight, bias, eps: float, width: int, total):
    """A LayerNorm over `width` columns of which x [..., w] holds a share,
    with the scale and bias of the same columns: `total` sums a per-share
    statistic [..., 1] over the shares (parallel.collectives.sum_over_tensor
    over the tensor group), first the column sum for the mean, then the sum
    of the squared deviations from it for the variance (two passes, so that
    no E[x^2] - E[x]^2 cancellation enters). f32 statistics and affine, the
    output in x's dtype."""
    xf = x.float()
    mean = total(xf.sum(-1, keepdim=True)) / width
    d = xf - mean
    var = total((d * d).sum(-1, keepdim=True)) / width
    return (d * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def row_parallel(x, layer: nn.Linear, dp):
    """A row-parallel product in x's dtype: this rank's partial product of
    its input shard x with its column shard of the weight, in f32, summed
    over the tensor group, then the whole bias added once and one rounding
    to x's dtype."""
    partial = _F32Product.apply(x, layer.weight.to(x.dtype))
    out = reduce_from_tensor(partial, dp)
    if layer.bias is not None:
        out = out + layer.bias.to(x.dtype).float()
    return out.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. GELU is the tanh approximation (flax's default,
    which reed_tpu trains with) unless `exact_gelu`, the erf form of the
    torch reference checkpoints. With `tensor` T above 1 the layer holds a
    tensor rank's shards: fc1's hidden columns (and bias) and fc2's matching
    input columns, its whole bias added once after the reduce (Megatron)."""

    def __init__(self, in_dim: int, hidden_dim: int, exact_gelu: bool = False,
                 tensor: int = 1):
        super().__init__()
        if hidden_dim % tensor:
            raise ValueError(f"tensor={tensor} does not divide the MLP's {hidden_dim} "
                             "hidden units")
        self.tensor = tensor
        self.fc1 = nn.Linear(in_dim, hidden_dim // tensor)
        self.fc2 = nn.Linear(hidden_dim // tensor, in_dim)
        self.approximate = "none" if exact_gelu else "tanh"

    def forward(self, x, parallel=None):
        if self.tensor == 1:
            return linear(F.gelu(linear(x, self.fc1), approximate=self.approximate),
                          self.fc2)
        h = F.gelu(linear(copy_to_tensor(x, parallel), self.fc1),
                   approximate=self.approximate)
        return row_parallel(h, self.fc2, parallel)


class Attention(nn.Module):
    """Multi-head self-attention with fused qkv projection. With `tensor` T
    above 1 the layer holds a tensor rank's heads: qkv's rows (and bias) of
    its H/T heads of q, k and v, and proj's matching input columns, proj's
    whole bias added once after the reduce (Megatron). Under the seq axis
    (`parallel.seq` above 1) x is the rank's token slice: its queries
    attend to every rank's keys and values, gathered over the seq group."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, tensor: int = 1):
        super().__init__()
        if num_heads % tensor:
            raise ValueError(f"tensor={tensor} does not divide the {num_heads} attention "
                             "heads (qkv is split by heads)")
        self.tensor = tensor
        self.head_dim = dim // num_heads
        self.num_heads = num_heads // tensor  # this rank's
        self.qkv = nn.Linear(dim, 3 * dim // tensor, bias=qkv_bias)
        self.proj = nn.Linear(dim // tensor, dim)

    def forward(self, x, attn_impl: str = "auto", parallel=None):
        b, t, _ = x.shape
        h = copy_to_tensor(x, parallel) if self.tensor > 1 else x
        qkv = linear(h, self.qkv).reshape(b, t, 3, self.num_heads, self.head_dim)
        # strided views into qkv (the keys and values gathered over seq):
        # the kernel takes them without a copy
        kv = gather_seq(qkv[:, :, 1:], 1, parallel)
        out = multi_head_attention(qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1],
                                   impl=attn_impl)
        out = out.reshape(b, t, self.num_heads * self.head_dim)
        if self.tensor == 1:
            return linear(out, self.proj)
        return row_parallel(out, self.proj, parallel)


def patchify(x, patch_size: int):
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] (row-major patches)."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x, patch_size: int, channels: int):
    """[B, T, p*p*C] -> [B, H, W, C]."""
    b, t, _ = x.shape
    p = patch_size
    hw = math.isqrt(t)
    if hw * hw != t:
        raise ValueError(f"unpatchify needs a square token grid, got T={t}")
    x = x.reshape(b, hw, hw, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hw * p, hw * p, channels)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Fixed 2D sin-cos position embedding [grid*grid, D], f32."""

    def get_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d(embed_dim // 2, grid[0])
    emb_w = get_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
