"""Frozen encoder registry: name -> (model, preprocessing, z_dim),
counterpart of reed_tpu/encoders/registry.py.

'enc_type' strings like 'dinov2-vit-b' or comma-separated lists, ImageNet
and CLIP normalisation, the resize to the encoder's resolution, and the
text-embedding widths (TEXT_Z_DIM_DICT). Weights load from
`{encoder_dir}/{name}.npz` in the layout reed_tpu's `save_npz_params`
writes (`params/...`); without that file the encoder has no weights and
`encode` raises, as reed_tpu's does. The preprocessing (uint8 -> float,
bicubic resize as jax.image.resize, normalisation) runs on the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch import resolve_device
from reed_tpu_torch.encoders import flax_tree
from reed_tpu_torch.encoders.vit import ViT, ViTConfig, state_dict_from_flax

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# text-embedding widths per captioning model
TEXT_Z_DIM_DICT = {"qwen2b": 1536, "qwen7b": 3584, "qwen2.5-3b": 2048}

VIT_SIZES = {
    "s": dict(hidden_size=384, depth=12, num_heads=6),
    "b": dict(hidden_size=768, depth=12, num_heads=12),
    "l": dict(hidden_size=1024, depth=24, num_heads=16),
}
FAMILIES = {
    # family: (patch, image_size, layerscale, resize_to_image_size, mean, std)
    "dinov2": (14, 224, True, True, IMAGENET_MEAN, IMAGENET_STD),
    "dinov1": (16, 224, False, False, IMAGENET_MEAN, IMAGENET_STD),
    "mocov3": (16, 224, False, False, IMAGENET_MEAN, IMAGENET_STD),
    "mae": (16, 224, False, False, IMAGENET_MEAN, IMAGENET_STD),
    "jepa": (14, 224, False, True, IMAGENET_MEAN, IMAGENET_STD),
    "clip": (14, 224, False, True, CLIP_MEAN, CLIP_STD),
}


def vit_config(name: str) -> ViTConfig:
    """The ViTConfig of an encoder name such as 'dinov2-vit-b'."""
    family, _, size = name.strip().split("-")
    if family not in FAMILIES:
        raise NotImplementedError(f"encoder family {family!r}")
    patch, img, layerscale, _, _, _ = FAMILIES[family]
    return ViTConfig(image_size=img, patch_size=patch, layerscale=layerscale,
                     **VIT_SIZES[size])


def _make_preprocess(mean, std, resize_to: Optional[int], resolution: int):
    """preprocess(uint8 [B, H, W, 3] tensor) -> normalised f32 [B, H', W', 3]
    on the tensor's device: /255, bicubic resize to resize_to *
    (resolution // 256) where given, then (x - mean) / std."""
    def preprocess(x):
        x = x.float() / 255.0
        if resize_to is not None:
            target = resize_to * (resolution // 256)
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(target, target), mode="bicubic",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std, dtype=torch.float32, device=x.device)
        return (x - m) / s

    return preprocess


@dataclass
class FrozenEncoder:
    name: str
    family: str
    model: Optional[ViT]     # None: no weights were found
    z_dim: int
    preprocess: Callable

    @torch.no_grad()
    def __call__(self, pixels):
        """Preprocessed pixels [B, H, W, 3] -> per-patch features [B, T, D]."""
        if self.model is None:
            raise RuntimeError(f"no weights loaded for {self.name}; set "
                               "REED_TPU_ENCODER_DIR or pass --encoder-dir")
        return self.model(pixels, output="patch")

    def encode(self, raw_pixels):
        """Raw uint8 [B, H, W, 3] (numpy or tensor) -> features on the
        encoder's device, preprocessed there: the in-loop frozen-encoder
        path."""
        if self.model is None:
            raise RuntimeError(f"no weights loaded for {self.name}")
        if not isinstance(raw_pixels, torch.Tensor):
            raw_pixels = torch.from_numpy(np.asarray(raw_pixels))
        return self(self.preprocess(raw_pixels.to(self.model.pos_embed.device)))


def encode_features(encoders: List[FrozenEncoder], raw_pixels) -> List[torch.Tensor]:
    """Per-batch frozen-encoder features, the alignment targets."""
    return [enc.encode(raw_pixels) for enc in encoders]


def load_encoders(enc_type: str, resolution: int = 256,
                  encoder_dir: Optional[str] = None, device=None
                  ) -> Tuple[List[FrozenEncoder], List[str], List[str]]:
    """'dinov2-vit-b,clip-vit-l' -> (encoders, encoder types,
    architectures), each on `device` (default cuda) in eval mode, with the
    weights of {encoder_dir}/{name}.npz where that file exists
    (encoder_dir defaults to $REED_TPU_ENCODER_DIR)."""
    encoder_dir = encoder_dir or os.environ.get("REED_TPU_ENCODER_DIR")
    if resolution not in (256, 512):
        raise ValueError(f"resolution must be 256 or 512, got {resolution}")
    device = resolve_device(device)
    encoders, enc_types, architectures = [], [], []
    for one in enc_type.split(","):
        one = one.strip()
        family, arch, _ = one.split("-")
        cfg = vit_config(one)
        _, img, _, resize, mean, std = FAMILIES[family]
        model = None
        path = os.path.join(encoder_dir, f"{one}.npz") if encoder_dir else None
        if path and os.path.exists(path):
            model = ViT(cfg)
            model.load_state_dict(state_dict_from_flax(flax_tree.load_npz(path), model))
            model = model.to(device).eval().requires_grad_(False)
        encoders.append(FrozenEncoder(
            name=one, family=family, model=model, z_dim=cfg.hidden_size,
            preprocess=_make_preprocess(mean, std, img if resize else None, resolution)))
        enc_types.append(family)
        architectures.append(arch)
    return encoders, enc_types, architectures
