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
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from reed_tpu_torch.core.config import OptimConfig
from reed_tpu_torch.core.ema import ema_init


def global_norm(tensors: Sequence[torch.Tensor], plan=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm). With
    `plan` (a parallel.mesh.ShardPlan) `tensors` are a rank's state list,
    its tensor shards and fsdp chunks where sharded, and the norm is the
    whole list's: the chunks' squares summed over the fsdp group, the
    tensor shards' over the tensor group, the replicated leaves' added once
    (a collective), a sum in another order than the norm of the whole
    tensors."""
    if plan is not None and (plan.any_sharded or plan.any_tensor):
        return plan.norm(tensors)
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


def mu_step(mu: List[torch.Tensor], grads: List[torch.Tensor], b1: float
            ) -> List[torch.Tensor]:
    """Adam's first-moment update with mu stored in a narrower dtype than the
    gradients, as reed_tpu's jitted optax 0.2.6 step computes `(1 - b1) * g
    + b1 * mu`: b1 is weakly typed, so it is rounded to mu's dtype (0.9 ->
    0.8984375 in bf16), while XLA fuses mu's upcast into the product, so
    the product and the sum are in the gradients' dtype. Returns that
    unrounded sum (the bias correction reads it) and stores it in `mu`,
    rounded to mu's dtype."""
    b1_mu = float(torch.tensor(b1, dtype=mu[0].dtype))
    new = torch._foreach_mul(grads, 1.0 - b1)
    torch._foreach_add_(new, mu, alpha=b1_mu)
    torch._foreach_copy_(mu, new)
    return new


class Optimizer:
    """Global-norm clip (optax.clip_by_global_norm: scale by max_norm / norm
    only when norm >= max_norm, no eps), then Adam or AdamW (optax's update,
    eps outside the square root, bias correction by the count after the
    update), then -lr(count before the update); with accum_steps = k the
    gradients of k calls are averaged (Welford, as optax.MultiSteps) and the
    update is applied on every k-th call only. Parameters are updated in
    place; the state is f32 like the parameters, except Adam's first moment
    when cfg.mu_dtype names another dtype: it is stored in that dtype and
    updated as optax 0.2.6's scale_by_adam does (`mu_step`).

    With `plan` (a parallel.mesh.ShardPlan over the fsdp and tensor axes)
    the update runs on this rank's share: `params` are its tensor shards,
    and the chunks of the fsdp-sharded parameters, which the model holds
    sharded at rest (ShardPlan.attach); `step` takes the gradients as
    ShardPlan.reduce_grads leaves them, and mu, nu and acc are in the
    parameters' shapes. Every operation but the clip's norm is
    elementwise, so a chunk's update is bitwise the slice of the whole
    update."""

    def __init__(self, cfg: OptimConfig, params: List[torch.Tensor], plan=None):
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        self.cfg = cfg
        self.params = list(params)
        self.plan = plan
        self.lr = lr_schedule(cfg)
        self.count = 0       # committed updates
        self.mini_step = 0   # micro-steps into the current accumulation
        mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> bool:
        """Take one micro-step's gradients; returns whether an update was
        applied. `grads` may be modified. `norm`, where given, is
        global_norm(grads, plan), which the clip then reuses when the
        update takes these gradients as they are (no accumulation)."""
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
            norm = None
        if cfg.grad_clip is not None:
            if norm is None:
                norm = global_norm(grads, self.plan)
            keep = norm < cfg.grad_clip
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * cfg.grad_clip))
        lr = self.lr(self.count)
        self.count += 1
        if self.mu[0].dtype == self.params[0].dtype:
            torch._foreach_mul_(self.mu, cfg.b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - cfg.b1)
            mu = self.mu
        else:
            mu = mu_step(self.mu, grads, cfg.b1)
        torch._foreach_mul_(self.nu, cfg.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - cfg.b2)
        mu_hat = torch._foreach_div(mu, _bias_correction(cfg.b1, self.count))
        denom = torch._foreach_div(self.nu, _bias_correction(cfg.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(mu_hat, denom)
        if cfg.weight_decay > 0:
            torch._foreach_add_(mu_hat, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, mu_hat, alpha=-lr)
        return True


def make_optimizer(cfg: OptimConfig, params: List[torch.Tensor], plan=None) -> Optimizer:
    """The optimizer reed_tpu's make_optimizer builds, over `params` (this
    rank's share of them under `plan`, a ShardPlan)."""
    return Optimizer(cfg, params, plan)


@dataclass
class TrainState:
    """What a train step reads and updates: the step count (micro-steps),
    the model (its parameters), their EMA and the optimizer state."""

    step: int
    model: nn.Module
    ema: Dict[str, torch.Tensor]
    opt: Optimizer


def init_train_state(model: nn.Module, optim: OptimConfig, ema_dtype: Optional[str] = None,
                     dp=None, tp_rules=(), sync_replicated: bool = False) -> TrainState:
    """The state at step 0 of `model`: its EMA (in `ema_dtype`) and
    optimizer, each over this rank's share where `dp` (a
    parallel.mesh.DataParallel) has an fsdp or tensor axis above 1 (the
    plan is state.opt.plan; `tp_rules` name the parameters that `model`
    holds tensor shards of; `sync_replicated` as ShardPlan's). Where the
    plan shards over fsdp, `model` is sharded at rest (ShardPlan.attach)
    before the EMA and the optimizer take its parameters."""
    plan = None if dp is None else dp.shard_plan(model.named_parameters(), tp_rules,
                                                 sync_replicated)
    if plan is not None and plan.any_sharded:
        plan.attach(model)
    return TrainState(step=0, model=model, ema=ema_init(model, ema_dtype, plan),
                      opt=make_optimizer(optim, list(model.parameters()), plan))
