"""Continuous interpolant paths for stochastic-interpolant flow matching.

Convention (as reed_tpu/diffusion/paths.py): t=0 is clean data, t=1 is
noise; x_t = alpha_t * x + sigma_t * eps; velocity target
v = d_alpha_t * x + d_sigma_t * eps.
"""

from __future__ import annotations

import math

import torch

from reed_tpu_torch.parallel import draws


def interpolant(t, path_type: str = "linear"):
    """Returns (alpha_t, sigma_t, d_alpha_t, d_sigma_t) as f32 tensors,
    broadcastable with t."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if path_type == "linear":
        return 1.0 - t, t, -torch.ones_like(t), torch.ones_like(t)
    if path_type == "cosine":
        a = torch.cos(t * math.pi / 2)
        s = torch.sin(t * math.pi / 2)
        return a, s, -math.pi / 2 * s, math.pi / 2 * a
    raise NotImplementedError(f"path_type={path_type!r}")


def score_from_velocity(v, x_t, t, path_type: str = "linear"):
    """Convert a velocity prediction into a score estimate; t broadcastable
    with x_t."""
    alpha_t, sigma_t, d_alpha_t, d_sigma_t = interpolant(t, path_type)
    reverse_alpha_ratio = alpha_t / d_alpha_t
    var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
    return (reverse_alpha_ratio * v - x_t) / var


def velocity_from_score(score, x_t, t, path_type: str = "linear"):
    """Inverse of score_from_velocity."""
    alpha_t, sigma_t, d_alpha_t, d_sigma_t = interpolant(t, path_type)
    reverse_alpha_ratio = alpha_t / d_alpha_t
    var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
    return (score * var + x_t) / reverse_alpha_ratio


def diffusion_coefficient(t):
    """SDE diffusion schedule g(t) = 2t."""
    return 2.0 * t


def sample_time(generator, batch: int, weighting: str = "uniform",
                path_type: str = "linear", draw=None):
    """Training times [batch], f32, on the generator's device. 'uniform'
    draws U(0, 1); 'lognormal' maps sigma = exp(N(0, 1)) to sigma / (1 +
    sigma) on the linear path and to 2/pi * atan(sigma) on the cosine path
    (the EDM sigma-lognormal mapping). `draw` replaces the U(0, 1) or
    N(0, 1) draw, so that a test can hand over reed_tpu's."""
    device = None if generator is None else generator.device
    if weighting == "uniform":
        if draw is None:
            draw = draws.rand((batch,), generator=generator, device=device)
        return torch.as_tensor(draw, dtype=torch.float32)
    if weighting == "lognormal":
        if draw is None:
            draw = draws.randn((batch,), generator=generator, device=device)
        sigma = torch.exp(torch.as_tensor(draw, dtype=torch.float32))
        if path_type == "linear":
            return sigma / (1.0 + sigma)
        if path_type == "cosine":
            return 2.0 / math.pi * torch.atan(sigma)
    raise NotImplementedError(f"weighting={weighting!r}")
