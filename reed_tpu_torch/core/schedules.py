"""Training curricula and time-weight schedules as pure functions,
counterpart of reed_tpu/core/schedules.py.

Each takes a step (or t) as a number or a tensor and returns an f32 tensor,
computed as reed_tpu computes it in f32.
"""

from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def repa_weight_decay(step, repa_steps: float, kind: str = "constant"):
    """Alignment-loss weight as a function of training step.

    kinds: constant | linear | cosine  (reference: image/train.py:363-370).
    """
    s = _f32(step)
    if kind == "constant":
        return torch.ones_like(s)
    if kind == "linear":
        return torch.clamp(1.0 - s / repa_steps, min=0.0)
    if kind == "cosine":
        return torch.clamp((1.0 + torch.cos(math.pi * s / repa_steps)) / 2.0, min=0.0)
    raise NotImplementedError(f"repa_weight_decay kind={kind!r}")


def diffusion_loss_decay(step, start_steps: float, warmup_steps: float,
                         max_steps: float, kind: str = "constant"):
    """Denoising-loss weight: 0 before `start_steps`, a linear ramp over
    `warmup_steps`, then a constant/linear/cosine tail over the remainder
    (reference: image/train.py:372-385, with the intended
    `(step - top) / (max_steps - top)` in the cosine tail)."""
    s = _f32(step)
    top = start_steps + warmup_steps
    ramp = (s - start_steps) / max(warmup_steps, 1.0)
    if kind == "constant":
        tail = torch.ones_like(s)
    elif kind == "linear":
        tail = 1.0 - (s - top) / max(max_steps - top, 1.0)
    elif kind == "cosine":
        tail = (1.0 + torch.cos(math.pi * (s - top) / max(max_steps - top, 1.0))) / 2.0
    else:
        raise NotImplementedError(f"diffusion_loss_decay kind={kind!r}")
    zero = torch.zeros_like(s)
    return torch.where(s < start_steps, zero, torch.where(s < top, ramp, tail))


def time_weight(t, base_weight: float = 1.0, kind: str = "constant",
                cutoffs=(0.0, 1.0)):
    """Per-sample time-dependent weight on the alignment loss
    (reference: image/loss.py:118-151; t = 0 is the clean sample)."""
    t = _f32(t)
    if kind == "linear":
        scale = 1.0 - t
    elif kind == "cosine":
        scale = 0.5 * (1.0 + torch.cos(math.pi * t))
    elif kind == "sigmoid":
        sharpness, midpoint = 10.0, 0.5
        scale = 1.0 / (1.0 + torch.exp((t - midpoint) * sharpness))
    elif kind == "constant":
        scale = torch.ones_like(t)
    elif kind == "loglinear":
        scale = 1.0 - torch.log(t + 1.0)
    elif kind == "cutoff":
        scale = torch.where((t < cutoffs[0]) | (t > cutoffs[1]), 0.0, 1.0)
    else:
        raise NotImplementedError(f"time_weight kind={kind!r}")
    return base_weight * scale


def encoder_weight(base_weight: float, step, total_steps: float,
                   kind: str = "linear", focus: str = "text",
                   transition_point: float = 0.5, sharpness: float = 10.0):
    """Training-progress-sensitive per-encoder weight
    (reference: image/loss.py:66-116)."""
    progress = _f32(step) / total_steps
    if kind == "linear":
        scale = 1.0 - progress if focus == "text" else progress
    elif kind == "cosine":
        c = torch.cos(math.pi * progress)
        scale = 0.5 * (1.0 + c) if focus == "text" else 0.5 * (1.0 - c)
    elif kind == "sigmoid":
        sig = 1.0 / (1.0 + torch.exp((progress - transition_point) * sharpness))
        scale = sig if focus == "text" else 1.0 - sig
    else:
        raise ValueError(f"encoder_weight kind={kind!r}")
    return base_weight * scale


def cosine_anneal(step, total_steps: float, start: float, end: float):
    """Cosine annealing from `start` to `end` (reference: image/train.py:47-50)."""
    s = _f32(step)
    val = end + (start - end) / 2.0 * (1.0 + torch.cos(s / total_steps * math.pi))
    return torch.where(s >= total_steps, _f32(end), val)
