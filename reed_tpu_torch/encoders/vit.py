"""Frozen vision-transformer encoders (DINOv2, MAE, MoCo-v3, CLIP, I-JEPA
style), counterpart of reed_tpu/encoders/vit.py: one pre-norm ViT with a
cls token, optional register tokens, learnable position embeddings with
bicubic resampling, LayerScale, and a choice of output (patch tokens, cls
or pooled).

The state_dict names are timm's and DINOv2's (`patch_embed.proj`,
`blocks.{i}.attn.qkv`, `blocks.{i}.ls1.gamma`, ...), so reed_tpu's
`convert_torch_vit` loads a port state_dict unchanged; `to_flax` is the
port's copy of it and `state_dict_from_flax` its inverse (the patch
embedding's Dense kernel [p p 3, D] back to a [D, 3, p, p] conv).
Attention is plain, as reed_tpu computes it outside any Pallas kernel. The
MLP's GELU is the tanh approximation, as reed_tpu's flax `nn.gelu` (DINOv2
itself uses erf). Interfaces are NHWC.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.encoders import flax_tree


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    layerscale: bool = True          # DINOv2 uses LayerScale
    qkv_bias: bool = True
    ln_eps: float = 1e-6


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, bias=cfg.qkv_bias)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.num_heads, hd).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return self.proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d))


class ViTMlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = ViTAttention(cfg)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = ViTMlp(cfg)
        self.ls1 = LayerScale(d) if cfg.layerscale else nn.Identity()
        self.ls2 = LayerScale(d) if cfg.layerscale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = PatchEmbed(p, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.randn(1, 1 + (cfg.image_size // p) ** 2, d) * 0.02)
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.blocks = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)

    @flax_tree.full_f32
    def forward(self, x, output: str = "patch"):
        """x: preprocessed pixels [B, H, W, 3]. output: 'patch' (per-patch
        tokens, the alignment target), 'cls' or 'pooled'."""
        cfg = self.cfg
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(self.pos_embed.dtype))
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = resample_pos_embed(self.pos_embed, gh, gw)
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1) + pos
        if cfg.num_register_tokens:
            x = torch.cat([x[:, :1], self.register_tokens.expand(b, -1, d), x[:, 1:]], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        n_prefix = 1 + cfg.num_register_tokens
        if output == "patch":
            return x[:, n_prefix:]
        if output == "cls":
            return x[:, 0]
        if output == "pooled":
            return x[:, n_prefix:].mean(dim=1)
        raise ValueError(output)


def resample_pos_embed(pos_embed, gh: int, gw: int):
    """[1, 1 + side^2, D] position embeddings for a gh x gw patch grid:
    bicubic, antialiased as jax.image.resize (Keys a = -0.5; torch's plain
    bicubic is a = -0.75)."""
    n = pos_embed.shape[1] - 1
    side = int(math.sqrt(n))
    if side * side == gh * gw and side == gh:
        return pos_embed
    cls_pos, grid = pos_embed[:, :1], pos_embed[:, 1:]
    grid = grid.reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False,
                         antialias=True)
    return torch.cat([cls_pos, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


# -- weights: timm names <-> reed_tpu's flax tree ----------------------------

_BLOCK_RENAME = {"attn.qkv": "qkv", "attn.proj": "attn_proj", "mlp.fc1": "fc1",
                 "mlp.fc2": "fc2", "norm1": "norm1", "norm2": "norm2"}


def flax_key(name: str):
    """(path in reed_tpu's variables, layout) of a timm-named entry."""
    if name == "patch_embed.proj.weight":
        return ("params", "patch_embed", "kernel"), "patch"
    if name == "patch_embed.proj.bias":
        return ("params", "patch_embed", "bias"), "same"
    if name in ("cls_token", "pos_embed", "register_tokens"):
        return ("params", name), "same"
    m = re.match(r"blocks\.(\d+)\.(ls[12])\.gamma$", name)
    if m:
        return ("params", f"blocks_{m.group(1)}", f"{m.group(2)}_gamma"), "same"
    m = re.match(r"(?:blocks\.(\d+)\.)?(.+)\.(weight|bias)$", name)
    idx, module, leaf = m.groups()
    path = ("params",) if idx is None else ("params", f"blocks_{idx}")
    module = _BLOCK_RENAME.get(module, module) if idx is not None else module
    if module.startswith("norm"):
        return (*path, module, "scale" if leaf == "weight" else "bias"), "same"
    return (*path, module, "kernel" if leaf == "weight" else "bias"), (
        "dense" if leaf == "weight" else "same")


def to_flax(model: ViT) -> Dict:
    """The port's copy of reed_tpu's convert_torch_vit: {'params': ...}."""
    return flax_tree.to_flax(model.state_dict(), flax_key)


def state_dict_from_flax(variables, model: ViT) -> Dict[str, torch.Tensor]:
    """reed_tpu's ViT variables ({'params': ...}) as `model`'s state_dict."""
    return flax_tree.from_flax(variables, model.state_dict(), flax_key)
