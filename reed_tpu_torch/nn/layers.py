"""Shared neural-net building blocks (torch.nn), counterparts of
reed_tpu/nn/layers.py with the reference's parameter names.

Projector MLPs, timestep / label embedders, adaLN modulation, the SiT MLP and
fused-qkv attention, NHWC row-major patchify and the fixed 2D sin-cos
position embedding. Layers compute in the dtype of their parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.ops.attention import multi_head_attention


class ProjectorMLP(nn.Sequential):
    """3-layer SiLU MLP projecting backbone activations to an encoder's
    representation space (keys 0, 2, 4 as in the reference)."""

    def __init__(self, hidden_size: int, projector_dim: int, z_dim: int):
        super().__init__(
            nn.Linear(hidden_size, projector_dim), nn.SiLU(),
            nn.Linear(projector_dim, projector_dim), nn.SiLU(),
            nn.Linear(projector_dim, z_dim))


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

    def forward(self, t):
        x = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(x.to(self.mlp[0].weight.dtype))


class LabelEmbedder(nn.Module):
    """Class-label embedding; with dropout_prob > 0 the table has a trailing
    null (CFG) class at index num_classes."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(
            num_classes + int(dropout_prob > 0), hidden_size)

    def forward(self, y):
        return self.embedding_table(y)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. GELU is the tanh approximation (flax's default,
    which reed_tpu trains with) unless `exact_gelu`, the erf form of the
    torch reference checkpoints."""

    def __init__(self, in_dim: int, hidden_dim: int, exact_gelu: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, in_dim)
        self.approximate = "none" if exact_gelu else "tanh"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """Multi-head self-attention with fused qkv projection."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, attn_impl: str = "auto"):
        b, t, d = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, d // self.num_heads)
        # strided views into qkv: the kernel takes them without a copy
        out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   impl=attn_impl)
        return self.proj(out.reshape(b, t, d))


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
