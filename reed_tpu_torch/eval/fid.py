"""FID generation harness on one device: sample class-conditional latents
and write the `.npz` (key `arr_0`) consumed by the ADM evaluation suite.

Counterpart of reed_tpu/eval/fid.py. Each batch draws its latents, labels
and SDE noise from a torch.Generator seeded by (seed, batch index), so a
batch's samples do not depend on the batches before it. There is no VAE
decoder yet: the npz holds latents, as reed_tpu writes without `--vae`.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.diffusion.samplers import euler_maruyama_sampler, euler_sampler


@dataclass
class FIDGenConfig:
    num_samples: int = 50_000
    batch_size: int = 256
    num_classes: int = 1000
    latent_size: int = 32
    latent_channels: int = 4
    mode: str = "sde"                # sde | ode
    num_steps: int = 250
    cfg_scale: float = 1.0
    guidance_low: float = 0.0
    guidance_high: float = 1.0
    heun: bool = False
    path_type: str = "linear"
    seed: int = 0
    latents_scale: float = 0.18215
    latents_bias: float = 0.0


def batch_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of batch `index`, seeded from (seed, index)."""
    state = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1))
    return gen


@torch.no_grad()
def generate_samples(model_fn: Callable, cfg: FIDGenConfig, device=None,
                     out_npz: Optional[str] = None) -> np.ndarray:
    """model_fn(x, t, y) -> velocity. Returns [N, H, W, C] latents
    (x / latents_scale + latents_bias) and writes `out_npz` when given."""
    device = resolve_device(device)
    n_iters = math.ceil(cfg.num_samples / cfg.batch_size)
    shape = (cfg.batch_size, cfg.latent_size, cfg.latent_size,
             cfg.latent_channels)
    kwargs = dict(num_steps=cfg.num_steps, cfg_scale=cfg.cfg_scale,
                  guidance_low=cfg.guidance_low,
                  guidance_high=cfg.guidance_high,
                  num_classes=cfg.num_classes, path_type=cfg.path_type)
    outs, t0 = [], None
    for i in range(n_iters):
        gen = batch_generator(cfg.seed, i, device)
        z = torch.randn(shape, generator=gen, device=device)
        y = torch.randint(0, cfg.num_classes, (cfg.batch_size,),
                          generator=gen, device=device)
        if cfg.mode == "sde":
            x = euler_maruyama_sampler(model_fn, z, y, gen, **kwargs)
        else:
            x = euler_sampler(model_fn, z, y, heun=cfg.heun, **kwargs)
        outs.append((x / cfg.latents_scale + cfg.latents_bias).cpu().numpy())
        if i == 0:
            t0 = time.perf_counter()  # the first batch carries the kernel build
    if n_iters > 1:
        per_batch = (time.perf_counter() - t0) / (n_iters - 1)
        print(f"sampler throughput: {cfg.num_steps / per_batch:.1f} "
              f"steps/sec at batch {cfg.batch_size} "
              f"({cfg.batch_size / per_batch:.1f} imgs/sec)")
    samples = np.concatenate(outs, axis=0)[:cfg.num_samples]
    if out_npz is not None:
        os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
        np.savez(out_npz, arr_0=samples)
        print(f"saved {samples.shape} -> {out_npz}")
    return samples


def strip_projector_params(state_dict: Mapping) -> Dict:
    """Drop projector weights from a SiT state_dict (inference checkpoints)."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith("projectors.")}


def save_params_npz(path: str, state_dict: Mapping):
    """Write a state_dict as a flat npz, f32."""
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}
