"""Stable-Diffusion VAE (AutoencoderKL), counterpart of
reed_tpu/encoders/vae.py: the encoder to 8-channel moments and the decoder
from 4-channel latents.

The state_dict names are diffusers' AutoencoderKL names (`post_quant_conv`,
`decoder.up_blocks.{i}.resnets.{j}`, `decoder.mid_block.attentions.0.to_q`
as a Linear, ...), so reed_tpu's `convert_diffusers_vae` loads a port
state_dict unchanged; `to_flax` is the port's own copy of it and
`state_dict_from_flax` its inverse, which reads the npz of
tools/convert_vae.py. GroupNorm has min(32, C) groups and eps 1e-6; the
encoder's downsample pads the bottom and right by one, then applies a
VALID stride-2 conv; the decoder's upsample is nearest 2x. The mid-block
self-attention (1024 tokens at width 512 for a 256 px image) is plain
einsum and softmax, as reed_tpu computes it outside any Pallas kernel.
Interfaces are NHWC, as reed_tpu's; the convolutions run NCHW, in full f32
(`flax_tree.full_f32`). Pixels are in [-1, 1]; the encoder returns moments
[B, H/8, W/8, 8] (mean, logvar).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.encoders import flax_tree


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H x W positions (NCHW in and
    out); q, k, v and the output projection are Linear layers."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = _gn(channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k).float()
                             / math.sqrt(c), dim=-1).to(v.dtype)
        o = self.to_out[0](torch.einsum("bqk,bkc->bqc", attn, v))
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels),
                                      ResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([AttnBlock(channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Resample(nn.Module):
    """diffusers' Upsample2D / Downsample2D: one conv named `conv`."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Stage(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_res: int, resample: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(in_ch if j == 0 else out_ch, out_ch)
                                      for j in range(num_res)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Resample(out_ch, down=True)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Resample(out_ch, down=False)])

    def forward(self, x):
        for block in self.resnets:
            x = block(x)
        for sampler in (*getattr(self, "downsamplers", ()), *getattr(self, "upsamplers", ())):
            x = sampler(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, base_ch, ch_mult, num_res, z_ch):
        super().__init__()
        self.conv_in = nn.Conv2d(3, base_ch, 3, padding=1)
        chans = [base_ch * m for m in ch_mult]
        last = len(ch_mult) - 1
        self.down_blocks = nn.ModuleList([
            _Stage(([base_ch] + chans)[i], chans[i], num_res, "down" if i < last else None)
            for i in range(len(ch_mult))])
        self.mid_block = MidBlock(chans[-1])
        self.conv_norm_out = _gn(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], 2 * z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for stage in self.down_blocks:
            h = stage(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _Decoder(nn.Module):
    def __init__(self, base_ch, ch_mult, num_res, z_ch, out_ch):
        super().__init__()
        chans = [base_ch * m for m in reversed(ch_mult)]
        last = len(ch_mult) - 1
        self.conv_in = nn.Conv2d(z_ch, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0])
        self.up_blocks = nn.ModuleList([
            _Stage(chans[max(i - 1, 0)], chans[i], num_res, "up" if i < last else None)
            for i in range(len(ch_mult))])
        self.conv_norm_out = _gn(chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            h = stage(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEEncoder(nn.Module):
    """Pixels [B, H, W, 3] in [-1, 1] -> moments [B, H/8, W/8, 2 z_ch]."""

    def __init__(self, base_ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res: int = 2, z_ch: int = 4):
        super().__init__()
        self.encoder = _Encoder(base_ch, tuple(ch_mult), num_res, z_ch)
        self.quant_conv = nn.Conv2d(2 * z_ch, 2 * z_ch, 1)

    @flax_tree.full_f32
    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.quant_conv.weight.dtype)
        return self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)


class VAEDecoder(nn.Module):
    """Latents [B, h, w, z_ch] (unscaled) -> pixels [B, 8h, 8w, 3] in
    about [-1, 1]."""

    def __init__(self, base_ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res: int = 3, out_ch: int = 3, z_ch: int = 4):
        super().__init__()
        self.post_quant_conv = nn.Conv2d(z_ch, z_ch, 1)
        self.decoder = _Decoder(base_ch, tuple(ch_mult), num_res, z_ch, out_ch)

    @flax_tree.full_f32
    def forward(self, z):
        z = z.permute(0, 3, 1, 2).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


def sample_latents(moments, generator: Optional[torch.Generator] = None,
                   scale: float = 0.18215, eps=None):
    """Moments [B, H, W, 8] -> scaled latent sample [B, H, W, 4]; the
    normal draw comes from `generator` unless `eps` is given."""
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device)
    return (mean + std * eps) * scale


def to_uint8(x):
    """Decoder output in [-1, 1] -> uint8 pixels (clip((x + 1) / 2) * 255 + 0.5,
    truncated)."""
    x = ((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)
    return (x * 255.0 + 0.5).to(torch.uint8)


@torch.no_grad()
def decode_latents(decoder: VAEDecoder, latents, scale: float = 0.18215):
    """Scaled latents [B, H, W, 4] -> uint8 images [B, 8H, 8W, 3]."""
    return to_uint8(decoder(latents / scale))


# -- weights: diffusers names <-> reed_tpu's flax tree ----------------------

_GN_NAMES = ("norm1", "norm2", "group_norm", "conv_norm_out")
_RENAME = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v",
           "to_out.0": "proj_out", "conv_shortcut": "nin_shortcut",
           "conv_norm_out": "norm_out"}


def flax_key(name: str):
    """(path in reed_tpu's variables, layout) of a diffusers-named entry."""
    body = re.sub(r"^(encoder|decoder)\.", "", name)
    module, leaf = body.rsplit(".", 1)
    path = []
    m = re.match(r"mid_block\.(resnets|attentions)\.(\d+)\.?(.*)", module)
    if m:
        kind, idx, rest = m.groups()
        path.append(f"mid_block_{int(idx) + 1}" if kind == "resnets" else "mid_attn_1")
        module = rest
    m = re.match(r"(up|down)_blocks\.(\d+)\.(resnets|upsamplers|downsamplers)\.(\d+)\.?(.*)",
                 module)
    if m:
        direction, i, kind, j, rest = m.groups()
        path.append(f"{direction}_{i}_block_{j}" if kind == "resnets"
                    else f"{direction}_{i}_{kind[:-2]}")
        module = "" if rest == "conv" else rest
    if module:
        path.append(_RENAME.get(module, module))
    last = module.rsplit(".", 1)[-1]
    if last in _GN_NAMES:
        return ("params", *path, "GroupNorm_0", "scale" if leaf == "weight" else "bias"), "same"
    if leaf == "bias":
        return ("params", *path, "bias"), "same"
    layout = "linear_conv" if last in ("to_q", "to_k", "to_v") or module.endswith("to_out.0") \
        else "conv"
    return ("params", *path, "kernel"), layout


def to_flax(model: nn.Module) -> Dict:
    """The port's copy of reed_tpu's convert_diffusers_vae: {'params': ...}."""
    return flax_tree.to_flax(model.state_dict(), flax_key)


def state_dict_from_flax(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """reed_tpu's VAE variables ({'params': ...}) as `model`'s state_dict."""
    return flax_tree.from_flax(variables, model.state_dict(), flax_key)


def _widths(params, prefix: str):
    """(base_ch, ch_mult, num_res) of a VAE variable tree, read from its
    stages' first convolutions (`prefix` 'up' or 'down')."""
    stages = sorted({int(k.split("_")[1]) for k in params if k.startswith(prefix + "_")})
    num_res = sum(1 for k in params if k.startswith(f"{prefix}_0_block_"))
    chans = [params[f"{prefix}_{i}_block_0"]["conv1"]["kernel"].shape[-1] for i in stages]
    if prefix == "up":
        chans = chans[::-1]
    return chans[0], tuple(c // chans[0] for c in chans), num_res


def load_npz(path: str, part: str = "decoder") -> nn.Module:
    """The VAEDecoder (or VAEEncoder, part='encoder') of a flat npz in
    reed_tpu's layout (tools/convert_vae.py: `params/...` keys), at the
    widths the weights have (SD-VAE: base 128, ch_mult (1, 2, 4, 4))."""
    variables = flax_tree.load_npz(path)
    params = variables["params"]
    if part == "decoder":
        base, mult, num_res = _widths(params, "up")
        model = VAEDecoder(base, mult, num_res,
                           out_ch=params["conv_out"]["kernel"].shape[-1],
                           z_ch=params["post_quant_conv"]["kernel"].shape[-1])
    else:
        base, mult, num_res = _widths(params, "down")
        model = VAEEncoder(base, mult, num_res,
                           z_ch=params["quant_conv"]["kernel"].shape[-1] // 2)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return model
