"""ODE/SDE samplers with classifier-free guidance inside a guidance interval.

Counterparts of reed_tpu/diffusion/samplers.py: Euler (+ Heun) ODE and
Euler-Maruyama SDE with velocity->score conversion, CFG applied only for
t in [guidance_low, guidance_high], and a deterministic final SDE step.
The integrator state is f32, as in reed_tpu (the torch reference integrates
in float64). The time grid and the guidance-window test are computed in f32
exactly as jnp.linspace does, so a step on a window boundary falls the same
way as in reed_tpu. The loops run on the host; each step is one model call
(two batches stacked inside the window, one batch outside it).

`model_fn(x, t, y) -> v` is the velocity network.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from reed_tpu_torch.diffusion.paths import diffusion_coefficient, score_from_velocity


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num, dtype=float32), with its f32 formula
    start * (1 - step) + stop * step and the exact endpoint."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = start * (np.float32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def _cfg_active(t_cur: np.float32, cfg_scale: float, guidance_low: float,
                guidance_high: float) -> bool:
    return bool(cfg_scale > 1.0 and np.float32(guidance_low) <= t_cur
                <= np.float32(guidance_high))


def _time(t: np.float32, n: int, device) -> torch.Tensor:
    return torch.full((n,), float(t), dtype=torch.float32, device=device)


def _guided_velocity(model_fn, x, t_cur, y, cfg_scale, guidance_low,
                     guidance_high, num_classes):
    """Velocity with CFG inside [guidance_low, guidance_high]; outside it,
    one call on the single batch gives the conditional velocity."""
    b = x.shape[0]
    if not _cfg_active(t_cur, cfg_scale, guidance_low, guidance_high):
        return model_fn(x, _time(t_cur, b, x.device), y).float()
    y_in = torch.cat([y, torch.full_like(y, num_classes)])
    v = model_fn(torch.cat([x, x]), _time(t_cur, 2 * b, x.device), y_in).float()
    v_cond, v_uncond = v.chunk(2)
    return v_uncond + cfg_scale * (v_cond - v_uncond)


def euler_sampler(model_fn: Callable, latents, y, num_steps: int = 20,
                  heun: bool = False, cfg_scale: float = 1.0,
                  guidance_low: float = 0.0, guidance_high: float = 1.0,
                  num_classes: int = 1000, path_type: str = "linear"):
    """Probability-flow ODE sampler from t=1 (noise) to t=0 (data); Heun's
    correction on every step but the last."""
    del path_type
    t_steps = _linspace_f32(1.0, 0.0, num_steps + 1)
    x = latents.float()
    guide = dict(cfg_scale=cfg_scale, guidance_low=guidance_low,
                 guidance_high=guidance_high, num_classes=num_classes)
    for i in range(num_steps):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        dt = float(t_next - t_cur)
        d_cur = _guided_velocity(model_fn, x, t_cur, y, **guide)
        x_euler = x + dt * d_cur
        if heun and i < num_steps - 1:
            d_prime = _guided_velocity(model_fn, x_euler, t_next, y, **guide)
            x = x + dt * 0.5 * (d_cur + d_prime)
        else:
            x = x_euler
    return x


def euler_maruyama_sampler(model_fn: Callable, latents, y,
                           generator: Optional[torch.Generator] = None,
                           num_steps: int = 20, cfg_scale: float = 1.0,
                           guidance_low: float = 0.0, guidance_high: float = 1.0,
                           num_classes: int = 1000, path_type: str = "linear",
                           t_min: float = 0.04, noise: Optional[torch.Tensor] = None):
    """SDE sampler: drift v - 0.5*g(t)*score with g(t)=2t, num_steps-1
    stochastic steps on t in [1, t_min], then one deterministic mean step to
    t=0. The step noise is drawn from `generator`, or taken from `noise`
    ([num_steps-1, *latents.shape]) when given."""
    x = latents.float()
    if noise is not None and tuple(noise.shape) != (num_steps - 1, *x.shape):
        raise ValueError(f"noise must have shape {(num_steps - 1, *x.shape)}, "
                         f"got {tuple(noise.shape)}")
    t_steps = np.concatenate([_linspace_f32(1.0, t_min, num_steps),
                              np.zeros(1, np.float32)])
    bcast = (1,) * (x.dim() - 1)

    def drift(x, t_cur):
        guided = _cfg_active(t_cur, cfg_scale, guidance_low, guidance_high)
        x_in = torch.cat([x, x]) if guided else x
        y_in = torch.cat([y, torch.full_like(y, num_classes)]) if guided else y
        t_in = _time(t_cur, x_in.shape[0], x.device)
        v = model_fn(x_in, t_in, y_in).float()
        # score on the (stacked) batch, then guidance on the drift
        s = score_from_velocity(v, x_in, t_in.view(-1, *bcast), path_type)
        d = v - float(np.float32(0.5) * diffusion_coefficient(t_cur)) * s
        if not guided:
            return d
        d_cond, d_uncond = d.chunk(2)
        return d_uncond + cfg_scale * (d_cond - d_uncond)

    for i in range(num_steps - 1):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        dt = t_next - t_cur
        if noise is not None:
            eps = noise[i].to(device=x.device, dtype=torch.float32)
        else:
            eps = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=torch.float32)
        d_cur = drift(x, t_cur)
        sqrt_g = float(np.sqrt(diffusion_coefficient(t_cur)))
        x = x + d_cur * float(dt) + sqrt_g * eps * float(np.sqrt(np.abs(dt)))
    t_cur, t_next = t_steps[num_steps - 1], t_steps[num_steps]
    return x + float(t_next - t_cur) * drift(x, t_cur)
