"""SiT: Scalable Interpolant Transformer with REED projectors (torch.nn).

Counterpart of reed_tpu/models/sit.py with the reference's parameter names
(x_embedder.proj, t_embedder.mlp.{0,2}, y_embedder.embedding_table,
blocks.{i}.{adaLN_modulation.1,attn.{qkv,proj},mlp.{fc1,fc2}},
projectors.{j}.{0,2,4}, final_layer.{adaLN_modulation.1,linear}), so a
reference state_dict loads with `load_state_dict`. Inputs and outputs are
NHWC like reed_tpu's. The model computes in the dtype of its parameters:
build it in f32 and `.to(torch.bfloat16)` for bf16 compute; LayerNorm
statistics and the output are f32 either way.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import (
    Attention,
    LabelEmbedder,
    Mlp,
    ProjectorMLP,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
    modulate,
    patchify,
    unpatchify,
)


def layer_norm(x):
    """LayerNorm without affine parameters, eps 1e-6, statistics in f32
    (as flax computes them for a bf16 input)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class PatchEmbed(nn.Module):
    """Patch embedding. `proj` keeps the reference conv's weight shape
    [D, C, p, p] but is applied as row-major NHWC patchify + a linear map:
    the same arithmetic without cuDNN, whose f32 convolutions run in TF32."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size,
                              stride=patch_size)

    def forward(self, x):
        w = self.proj.weight
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # [D, p*p*C]
        return F.linear(patchify(x, self.patch_size), w, self.proj.bias)


class SiTBlock(nn.Module):
    """adaLN-Zero transformer block."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 exact_gelu: bool = False):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, qkv_bias=True)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       exact_gelu=exact_gelu)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x, c, attn_impl: str = "auto"):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        h = modulate(layer_norm(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None, :] * self.attn(h, attn_impl=attn_impl)
        h = modulate(layer_norm(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * self.mlp(h)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))
        self.linear = nn.Linear(hidden_size, patch_size ** 2 * out_channels)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class SiT(nn.Module):
    def __init__(self, input_size: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 1000,
                 encoder_depth: int = 8, encoder_depth_text: Optional[int] = None,
                 z_dims: Sequence[int] = (768,), z_types: Sequence[str] = ("i",),
                 projector_dim: int = 2048, attn_impl: str = "auto",
                 exact_gelu: bool = False):
        super().__init__()
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.encoder_depth = encoder_depth
        self.encoder_depth_text = encoder_depth_text
        self.z_types = tuple(z_types)
        # 'auto' (kernel on CUDA) or 'reference' (plain attention)
        self.attn_impl = attn_impl

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size,
                                        class_dropout_prob)
        pos = get_2d_sincos_pos_embed(hidden_size, input_size // patch_size)
        # fixed, recomputed at construction, so not part of the state_dict
        self.register_buffer(
            "pos_embed",
            torch.as_tensor(pos, device=self.x_embedder.proj.weight.device)[None],
            persistent=False)
        self.blocks = nn.ModuleList(
            SiTBlock(hidden_size, num_heads, mlp_ratio, exact_gelu=exact_gelu)
            for _ in range(depth))
        self.projectors = nn.ModuleList(
            ProjectorMLP(hidden_size, projector_dim, z) for z in z_dims)
        self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's initialisation: xavier-uniform linears (the patch
        embedding over its [D, p*p*C] view), N(0, 0.02) timestep MLP and
        label table, zero biases, zero adaLN and final layers (so the
        velocity is 0 at init)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1), generator=generator)
        nn.init.zeros_(self.x_embedder.proj.bias)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
        nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02,
                        generator=generator)
        for blk in self.blocks:
            nn.init.zeros_(blk.adaLN_modulation[1].weight)
            nn.init.zeros_(blk.adaLN_modulation[1].bias)
        for lin in (self.final_layer.adaLN_modulation[1], self.final_layer.linear):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x, t, y, return_zs: bool = False):
        """x: [B, H, W, C] NHWC latents; t: [B] in [0, 1] (0 = clean); y: [B]
        int labels (num_classes = null/CFG class). Returns (velocity f32
        NHWC, zs or None); zs are the projector outputs when return_zs."""
        x = self.x_embedder(x.to(self.x_embedder.proj.weight.dtype))
        x = x + self.pos_embed.to(x.dtype)
        c = self.t_embedder(t) + self.y_embedder(y)

        zs_image, zs_text = None, None
        depth_text = self.encoder_depth_text
        split_text = depth_text is not None and depth_text != self.encoder_depth
        for i, block in enumerate(self.blocks):
            x = block(x, c, attn_impl=self.attn_impl)
            if return_zs and (i + 1) == self.encoder_depth:
                if not split_text:
                    zs_image = [self.projectors[j](x if zt == "i" else x.mean(dim=1))
                                for j, zt in enumerate(self.z_types)]
                else:
                    zs_image = [self.projectors[j](x)
                                for j, zt in enumerate(self.z_types) if zt == "i"]
            if return_zs and split_text and (i + 1) == depth_text:
                zs_text = [self.projectors[j](x.mean(dim=1))
                           for j, zt in enumerate(self.z_types) if zt == "t"]

        zs = None
        if return_zs:
            zs = (list(zs_image or []) + list(zs_text or []) if split_text
                  else zs_image)
        x = self.final_layer(x, c)
        return unpatchify(x.float(), self.patch_size, self.in_channels), zs


# Size registry mirroring the reference's 12 configs.
_SIZES = {
    "SiT-XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "SiT-L": dict(depth=24, hidden_size=1024, num_heads=16),
    "SiT-B": dict(depth=12, hidden_size=768, num_heads=12),
    "SiT-S": dict(depth=12, hidden_size=384, num_heads=6),
}


def create_sit(name: str, device=None, **kwargs) -> SiT:
    """name: e.g. 'SiT-XL/2' (size x patch size); the module is built on
    `device` (default: the current default device), in f32."""
    size, patch = name.rsplit("/", 1)
    cfg = dict(_SIZES[size])
    cfg["patch_size"] = int(patch)
    cfg.update(kwargs)
    with torch.device(device) if device is not None else contextlib.nullcontext():
        return SiT(**cfg)


SiT_models = {
    f"{size}/{p}": (lambda size=size, p=p: dict(_SIZES[size], patch_size=p))
    for size in _SIZES for p in (2, 4, 8)
}
