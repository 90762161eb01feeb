"""FID generation harness: sample class-conditional latents, decode them
to pixels with the SD-VAE decoder, and write the `.npz` (key `arr_0`)
consumed by the ADM evaluation suite.

Counterpart of reed_tpu/eval/fid.py. Each batch draws its latents, labels
and SDE noise from a torch.Generator seeded by (seed, batch index), so a
batch's samples do not depend on the batches before it. Each batch is
decoded on the device before it is copied to the host; without a decoder
the npz holds latents, as reed_tpu writes without `--vae`. Under a process
group each batch is sharded over the ranks (reed_tpu's mesh sharding of
the sample batch): every rank draws the whole batch's latents, labels and
noise and keeps the rows of its batch index, samples and decodes them, and
the rows are gathered back over the batch indices, so the samples equal
one process's. The seq and tensor ranks of one batch index run one SiT
between them (models/sit.py): each model call returns the whole velocity
of their rows on each of them, so they take the same sampler steps.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from reed_tpu_torch import resolve_device, synchronize
from reed_tpu_torch.diffusion.samplers import euler_maruyama_sampler, euler_sampler
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.mesh import SIT_AXES, data_parallel, local_batch


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
                     out_npz: Optional[str] = None,
                     decode_fn: Optional[Callable] = None, mesh=None) -> np.ndarray:
    """model_fn(x, t, y) -> velocity. Returns [N, 8H, 8W, 3] uint8 pixels,
    decode_fn(x / latents_scale + latents_bias) of each batch on the
    device, or without decode_fn the [N, H, W, C] latents themselves; writes
    `out_npz` when given (by rank 0 under a process group, whose ranks each
    sample their rows of every batch and all return every sample). Under a
    `mesh` (a MeshConfig) the batch splits over the data x fsdp batch
    indices, as reed_tpu's batch_sharding splits it; the parameters are
    whole on every rank but under tensor, where model_fn's SiT holds a
    tensor rank's shards. Prints the rate of the batches after the first,
    with the sampling and the decode timed apart."""
    device = resolve_device(device)
    dp = data_parallel(mesh, batch_size=cfg.batch_size, axes=SIT_AXES)
    n_iters = math.ceil(cfg.num_samples / cfg.batch_size)
    shape = (cfg.batch_size, cfg.latent_size, cfg.latent_size,
             cfg.latent_channels)
    kwargs = dict(num_steps=cfg.num_steps, cfg_scale=cfg.cfg_scale,
                  guidance_low=cfg.guidance_low,
                  guidance_high=cfg.guidance_high,
                  num_classes=cfg.num_classes, path_type=cfg.path_type)
    outs = []
    # time the batches after the first, which carries the kernel build
    sample_s = decode_s = 0.0
    for i in range(n_iters):
        t0 = time.perf_counter()
        gen = batch_generator(cfg.seed, i, device)
        z = torch.randn(shape, generator=gen, device=device)
        y = torch.randint(0, cfg.num_classes, (cfg.batch_size,),
                          generator=gen, device=device)
        z, y = local_batch(dp, (z, y))
        with draws.global_rows(dp):  # the SDE noise of the whole batch, this rank's rows
            if cfg.mode == "sde":
                x = euler_maruyama_sampler(model_fn, z, y, gen, **kwargs)
            else:
                x = euler_sampler(model_fn, z, y, heun=cfg.heun, **kwargs)
        x = x / cfg.latents_scale + cfg.latents_bias
        synchronize(device)
        t1 = time.perf_counter()
        if decode_fn is not None:
            x = decode_fn(x)
        if dp is not None:
            x = dp.gather_rows(x)
        outs.append(x.cpu().numpy())
        if i:
            sample_s += t1 - t0
            decode_s += time.perf_counter() - t1
    if n_iters > 1 and (dp is None or dp.is_main):
        n = (n_iters - 1) * cfg.batch_size
        per_batch = sample_s / (n_iters - 1)
        print(f"sampler throughput: {cfg.num_steps / per_batch:.1f} "
              f"steps/sec at batch {cfg.batch_size} "
              f"({n / sample_s:.2f} imgs/sec without the decode)")
        if decode_fn is not None:
            print(f"decode: {1e3 * decode_s / n:.3f} ms per image; "
                  f"{n / (sample_s + decode_s):.2f} imgs/sec with the decode")
    samples = np.concatenate(outs, axis=0)[:cfg.num_samples]
    if out_npz is not None and (dp is None or dp.is_main):
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


def make_vae_decode_fn(vae_npz: Optional[str] = None, device=None
                       ) -> Optional[Callable]:
    """decode_fn(latents [B, h, w, C] on `device`) -> uint8 pixels
    [B, 8h, 8w, 3] on `device`, through the SD-VAE decoder read from the
    flat npz of tools/convert_vae.py (`params/...` keys). generate_samples
    un-scales the latents already, so the decoder applies directly. Returns
    None without an npz."""
    from reed_tpu_torch.encoders.vae import load_npz, to_uint8

    if vae_npz is None:
        return None
    device = resolve_device(device)
    decoder = load_npz(vae_npz).to(device).eval()

    @torch.no_grad()
    def decode_fn(latents):
        return to_uint8(decoder(latents.to(device)))

    return decode_fn
