"""Train state and optimizer, counterpart of reed_tpu/core/train_state.py.

`make_optimizer` builds the update rule reed_tpu gets from optax: an
optional global-norm clip, Adam or AdamW, a learning-rate schedule, and
gradient accumulation as optax.MultiSteps. It is written out here (with
torch's multi-tensor `_foreach` ops, a few launches per step) because
torch.optim differs from optax in places a parity test sees:
`clip_grad_norm_` divides by norm + 1e-6 (optax by the norm, and only when
it exceeds the limit), and optax evaluates the learning-rate schedule at the
count before the update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from reed_tpu_torch.core.config import OptimConfig


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init to end over `steps`, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0: init to 0 over `steps`."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive steps, got {steps}")
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))


def lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate at optimizer count `count` (0 for the first update)."""
    if cfg.schedule == "constant":
        return lambda count: cfg.lr
    if cfg.schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, total)
        warm = _linear(0.0, cfg.lr, cfg.warmup_steps)
        decay = _cosine(cfg.lr, cfg.total_steps - cfg.warmup_steps)
        return lambda count: warm(count) if count < cfg.warmup_steps else decay(
            count - cfg.warmup_steps)
    if cfg.schedule == "onecycle":
        # optax.linear_onecycle_schedule(total, lr): pct_start 0.3, pct_final
        # 0.85, div_factor 25, final_div_factor 1e4
        n = cfg.total_steps
        if n <= 0:
            raise ValueError(f"onecycle needs positive total_steps, got {n}")
        bounds = [0, int(0.3 * n), int(0.85 * n), n]
        values = [cfg.lr / 25.0, cfg.lr, cfg.lr / 25.0, cfg.lr / 25.0 / 1e4]

        def onecycle(count):
            for i in range(3):
                if bounds[i] <= count < bounds[i + 1]:
                    pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                    return (values[i + 1] - values[i]) * pct + values[i]
            return values[-1]
        return onecycle
    raise ValueError(f"schedule must be constant, cosine or onecycle, got {cfg.schedule!r}")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """Global-norm clip (optax.clip_by_global_norm: scale by max_norm / norm
    only when norm >= max_norm, no eps), then Adam or AdamW (optax's update,
    eps outside the square root, bias correction by the count after the
    update), then -lr(count before the update); with accum_steps = k the
    gradients of k calls are averaged (Welford, as optax.MultiSteps) and the
    update is applied on every k-th call only. Parameters are updated in
    place; the state is f32 like the parameters."""

    def __init__(self, cfg: OptimConfig, params: List[torch.Tensor]):
        if cfg.mu_dtype is not None:
            raise NotImplementedError(
                f"OptimConfig.mu_dtype={cfg.mu_dtype!r} is not ported: the "
                "port keeps Adam's moments in the parameters' dtype (f32)")
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        self.cfg = cfg
        self.params = list(params)
        self.lr = lr_schedule(cfg)
        self.count = 0       # committed updates
        self.mini_step = 0   # micro-steps into the current accumulation
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns whether an update was
        applied. `grads` may be modified."""
        cfg = self.cfg
        if self.acc is not None:
            # acc <- acc + (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % cfg.accum_steps
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if cfg.grad_clip is not None:
            norm = global_norm(grads)
            keep = norm < cfg.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * cfg.grad_clip))
        lr = self.lr(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, cfg.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - cfg.b2)
        mu_hat = torch._foreach_div(self.mu, _bias_correction(cfg.b1, self.count))
        denom = torch._foreach_div(self.nu, _bias_correction(cfg.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(mu_hat, denom)
        if cfg.weight_decay > 0:
            torch._foreach_add_(mu_hat, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, mu_hat, alpha=-lr)
        return True


def make_optimizer(cfg: OptimConfig, params: List[torch.Tensor]) -> Optimizer:
    """The optimizer reed_tpu's make_optimizer builds, over `params`."""
    return Optimizer(cfg, params)


@dataclass
class TrainState:
    """What a train step reads and updates: the step count (micro-steps),
    the model (its parameters), their EMA and the optimizer state."""

    step: int
    model: nn.Module
    ema: Dict[str, torch.Tensor]
    opt: Optimizer
