"""Image-domain data: cached VAE latents and frozen-encoder features, the
port's own copy of reed_tpu/data/image.py (numpy only).

The on-disk layout is directories of per-sample `.npy` files (`vae-sd/`
moments [8, 32, 32], `features/<enc>/` encoder targets,
`text_embeds_<name>/` pooled text embeddings, and `pixels/` raw uint8
crops [256, 256, 3] for the in-loop frozen encoders) indexed by a
`dataset.json` labels file. The loader yields fixed-shape numpy batches on
the host; the trainer moves them to the device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class ImageDatasetConfig:
    data_dir: str
    latents_subdir: str = "vae-sd"
    features_subdirs: Sequence[str] = ()      # e.g. ("features/dinov2",)
    text_embeds_subdir: Optional[str] = None  # e.g. "text_embeds_qwen7b_l15"
    pixels_subdir: Optional[str] = None       # raw uint8 crops for in-loop encoders
    latents_scale: float = 0.18215
    latents_bias: float = 0.0


class CachedLatentDataset:
    """Reads (vae moments, label, encoder feature arrays) per sample."""

    def __init__(self, cfg: ImageDatasetConfig):
        self.cfg = cfg
        with open(os.path.join(cfg.data_dir, "dataset.json")) as f:
            labels = json.load(f)["labels"]
        # labels: list of [filename, class]
        self.items: List = sorted(labels, key=lambda kv: kv[0])

    def __len__(self):
        return len(self.items)

    def _npy(self, subdir: str, fname: str) -> np.ndarray:
        base = os.path.splitext(os.path.basename(fname))[0] + ".npy"
        return np.load(os.path.join(self.cfg.data_dir, subdir, base))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        fname, label = self.items[idx]
        out = {"moments": self._npy(self.cfg.latents_subdir, fname).astype(np.float32),
               "y": np.int32(label)}
        for i, sub in enumerate(self.cfg.features_subdirs):
            out[f"z_{i}"] = self._npy(sub, fname).astype(np.float32)
        if self.cfg.text_embeds_subdir:
            out["z_text"] = self._npy(self.cfg.text_embeds_subdir,
                                      fname).astype(np.float32)
        if self.cfg.pixels_subdir:
            out["pixels"] = self._npy(self.cfg.pixels_subdir, fname)
        return out


def sample_posterior(rng: np.random.Generator, moments: np.ndarray,
                     scale: float, bias: float) -> np.ndarray:
    """VAE moments [B, 2C, H, W] -> latent sample [B, H, W, C] (NHWC)."""
    mean, std = np.split(moments, 2, axis=1)
    z = mean + std * rng.standard_normal(mean.shape).astype(np.float32)
    z = z * scale + bias
    return np.transpose(z, (0, 2, 3, 1))


def epoch_batches(dataset: CachedLatentDataset, batch_size: int, seed: int,
                  process_index: int = 0, process_count: int = 1
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled full batches of stacked arrays, as reed_tpu's epoch_batches
    gives process `process_index` of `process_count`: every process draws
    the same permutation and takes every process_count-th sample of it from
    its index, in batches of `batch_size` (its share of the global batch);
    the raw moments are sampled to latents here on the host."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(dataset))
    idx = idx[process_index::process_count]
    for b in range(len(idx) // batch_size):
        rows = [dataset[i] for i in idx[b * batch_size:(b + 1) * batch_size]]
        stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        x = sample_posterior(rng, stacked.pop("moments"),
                             dataset.cfg.latents_scale,
                             dataset.cfg.latents_bias)
        zs = [stacked[k] for k in sorted(stacked) if k.startswith("z_")
              and k != "z_text"]
        if "z_text" in stacked:
            zs.append(stacked["z_text"])
        batch = {"x": x, "y": stacked["y"], "zs": zs}
        if "pixels" in stacked:
            batch["pixels"] = stacked["pixels"]
        yield batch
