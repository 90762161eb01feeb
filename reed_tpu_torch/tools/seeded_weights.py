"""Seeded random weights for the frozen networks (SD-VAE, InceptionV3,
ViT), written as npz files in the layouts reed_tpu reads
(tools/convert_vae.py, inception.save_variables_npz,
registry.save_npz_params). The repository holds none of their pretrained
weights, so tests and chip_smoke.py drive these paths with weights drawn
here: every layer reaches the output (no zero-initialised branch, no
vanishing scale), so a wrong layer shows.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from reed_tpu_torch.encoders import flax_tree, inception, vae, vit


@torch.no_grad()
def fill_(model: nn.Module, generator: torch.Generator, gain: float = 1.0) -> nn.Module:
    """Draw every entry of `model`'s state_dict from `generator`: conv and
    linear weights N(0, gain^2 / fan_in), norm scales and LayerScale gammas
    U(0.5, 1.5), biases N(0, 0.05^2), BatchNorm running means N(0, 0.1^2)
    and variances U(0.5, 1.5), tokens and position embeddings N(0, 0.02^2)."""
    def draw(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=generator)
        return torch.rand(shape, generator=generator)

    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("cls_token", "pos_embed", "register_tokens"):
            value = 0.02 * draw(t.shape, "normal")
        elif leaf == "weight" and t.dim() >= 2:
            value = gain / math.sqrt(t[0].numel()) * draw(t.shape, "normal")
        elif leaf in ("weight", "gamma", "running_var"):
            value = 0.5 + draw(t.shape, "uniform")
        elif leaf == "running_mean":
            value = 0.1 * draw(t.shape, "normal")
        else:
            value = 0.05 * draw(t.shape, "normal")
        t.copy_(value)
    return model


def vae_decoder(seed: int = 0, **widths) -> vae.VAEDecoder:
    return fill_(vae.VAEDecoder(**widths), torch.Generator().manual_seed(seed)).eval()


def vae_encoder(seed: int = 0, **widths) -> vae.VAEEncoder:
    return fill_(vae.VAEEncoder(**widths), torch.Generator().manual_seed(seed)).eval()


def inception_v3(seed: int = 0) -> inception.InceptionV3Pool3:
    return fill_(inception.InceptionV3Pool3(), torch.Generator().manual_seed(seed),
                 gain=math.sqrt(2.0)).eval()


def vit_encoder(cfg: vit.ViTConfig, seed: int = 0) -> vit.ViT:
    return fill_(vit.ViT(cfg), torch.Generator().manual_seed(seed)).eval()


def save(model: nn.Module, path: str) -> str:
    """`model`'s weights as reed_tpu's flat npz (`params/...`, and
    `batch_stats/...` for Inception); returns the path."""
    to_flax = {vae.VAEDecoder: vae.to_flax, vae.VAEEncoder: vae.to_flax,
               inception.InceptionV3Pool3: inception.to_flax, vit.ViT: vit.to_flax}
    flax_tree.save_npz(path, to_flax[type(model)](model))
    return path

