"""Flow-matching training loss with multi-encoder representation alignment,
counterpart of reed_tpu/diffusion/continuous.py.

v-prediction MSE on the interpolant path plus, for each frozen encoder, a
time-weighted negative-cosine alignment between the backbone's projected
activations (z_tilde) and the encoder targets (z). Image-type targets are
per-token [B, T, D]; text-type targets are pooled [B, D]. The loss is
computed in f32 whatever the model's compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from reed_tpu_torch.core.schedules import time_weight
from reed_tpu_torch.diffusion.paths import interpolant, sample_time
from reed_tpu_torch.parallel import draws

IMAGE_ENCODERS = ("dinov2", "dinov1", "mocov3", "clip", "mae", "jepa")


def mean_flat(x):
    return x.mean(dim=tuple(range(1, x.dim())))


def cosine_alignment(z, z_tilde, eps: float = 1e-8):
    """-cos(z, z_tilde) averaged over tokens -> [B]. z, z_tilde: [B, T, D] or
    [B, D] (pooled). eps is added to each norm (a zero vector gives 0)."""
    if z.dim() == 2:
        z = z[:, None, :]
    if z_tilde.dim() == 2:
        z_tilde = z_tilde[:, None, :]
    zn = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + eps)
    zt = z_tilde / (torch.linalg.vector_norm(z_tilde, dim=-1, keepdim=True) + eps)
    return -(zn * zt).sum(dim=-1).mean(dim=-1)


@dataclass(frozen=True)
class FlowMatchingLossConfig:
    prediction: str = "v"
    path_type: str = "linear"          # linear | cosine
    weighting: str = "uniform"          # t-sampling: uniform | lognormal
    enc_names: Sequence[str] = ("dinov2",)
    loss_weights: Sequence[float] = (1.0,)   # per-encoder repa coefficients
    time_schedule: str = "constant"     # constant|linear|cosine|sigmoid|loglinear|cutoff
    cutoffs: Sequence[float] = (0.0, 1.0)


def flow_matching_loss(cfg: FlowMatchingLossConfig, model_fn: Callable, x, zs,
                       generator: Optional[torch.Generator] = None,
                       model_kwargs=None, t=None, eps=None):
    """The REED training loss of one batch.

    model_fn(x_t, t, **model_kwargs) -> (v_pred, zs_tilde)
    x:  [B, H, W, C] clean latents (or any [B, ...] tensor)
    zs: list of encoder targets, each [B, T, D] ('i') or [B, D] ('t')
    t [B] and eps (x's shape) are drawn from `generator` unless given.

    Returns a dict of f32 scalars: 'denoising_loss', 'proj_loss' and the
    mean alignment of the image and of the text encoders."""
    model_kwargs = model_kwargs or {}
    x = x.float()
    b = x.shape[0]
    if t is None:
        t = sample_time(generator, b, cfg.weighting, cfg.path_type)
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    t_b = t.reshape((b,) + (1,) * (x.dim() - 1))
    if eps is None:
        eps = draws.randn(x.shape, generator=generator, device=x.device)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=x.device)
    alpha_t, sigma_t, d_alpha_t, d_sigma_t = interpolant(t_b, cfg.path_type)
    x_t = alpha_t * x + sigma_t * eps
    if cfg.prediction != "v":
        raise NotImplementedError(cfg.prediction)
    target = d_alpha_t * x + d_sigma_t * eps

    v_pred, zs_tilde = model_fn(x_t, t, **model_kwargs)
    denoising_loss = mean_flat((v_pred.float() - target) ** 2).mean()

    zero = torch.zeros((), device=x.device)
    proj_loss = zero
    acc = {"image": (zero, 0), "text": (zero, 0)}
    for z, z_tilde, enc_name, base_w in zip(zs, zs_tilde, cfg.enc_names,
                                            cfg.loss_weights):
        # base weight 0 => projector-only training at unit weight
        # (reference: image/loss.py:218-219)
        wts = (torch.ones_like(t) if base_w == 0.0
               else time_weight(t, base_w, cfg.time_schedule, cfg.cutoffs))
        curr = cosine_alignment(z.float(), z_tilde.float())  # [B]
        proj_loss = proj_loss + (curr * wts).mean()
        key = ("image" if any(n in enc_name for n in IMAGE_ENCODERS)
               or len(cfg.enc_names) == 1 else "text")
        s, c = acc[key]
        acc[key] = (s + curr.mean(), c + 1)

    return {
        "denoising_loss": denoising_loss,
        "proj_loss": proj_loss,
        "img_proj_loss": acc["image"][0] / max(1, acc["image"][1]),
        "text_proj_loss": acc["text"][0] / max(1, acc["text"][1]),
    }
