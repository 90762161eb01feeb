"""Continuous interpolant paths for stochastic-interpolant flow matching.

Convention (as reed_tpu/diffusion/paths.py): t=0 is clean data, t=1 is
noise; x_t = alpha_t * x + sigma_t * eps; velocity target
v = d_alpha_t * x + d_sigma_t * eps.
"""

from __future__ import annotations

import math

import torch


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
