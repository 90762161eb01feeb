"""The train step: loss, curriculum, optimizer and EMA, counterpart of
reed_tpu/core/trainer.py (make_train_step, combine_losses)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from reed_tpu_torch.core.config import CurriculumConfig
from reed_tpu_torch.core.ema import ema_update
from reed_tpu_torch.core.schedules import diffusion_loss_decay, repa_weight_decay
from reed_tpu_torch.core.train_state import TrainState, global_norm


def combine_losses(metrics: Dict[str, torch.Tensor], step, cur: CurriculumConfig):
    """total = denoising * diffusion_decay(step) + proj * proj_coeff * repa_decay(step)."""
    dd = diffusion_loss_decay(step, cur.start_diffusion_steps,
                              cur.diffusion_warmup_steps, cur.max_steps,
                              cur.diffusion_decay)
    rw = repa_weight_decay(step, cur.repa_steps, cur.repa_decay)
    # the weights stay on the host: a host-to-device copy of a pageable
    # tensor would make the host wait for the device in the middle of a step
    dd, rw = float(dd), float(rw)
    total = metrics["denoising_loss"] * dd + metrics["proj_loss"] * cur.proj_coeff * rw
    return total, {"diffusion_decay": dd, "repa_decay": rw}


def make_train_step(loss_fn: Callable, curriculum: CurriculumConfig,
                    accum_steps: int = 1) -> Callable:
    """Build `train_step(state, batch, **inject) -> (state, metrics)`.

    loss_fn(model, batch, opt_step, **inject) -> metrics dict of scalar
    tensors with at least 'denoising_loss' ('proj_loss' is 0 when absent).
    The step updates `state` in place (parameters, optimizer, EMA, step) and
    returns it. With gradient accumulation `state.step` counts micro-steps:
    the curriculum sees the optimizer step step // accum_steps, and the EMA
    moves only on the micro-step that commits an update, and then only every
    `ema_every` optimizer steps with decay^ema_every (reed_tpu's semantics).
    Metrics add 'loss' (the combined total) and 'grad_norm' (of the
    micro-step's raw gradients)."""

    def train_step(state: TrainState, batch, **inject):
        opt_step = state.step // accum_steps
        metrics = dict(loss_fn(state.model, batch, opt_step, **inject))
        if "proj_loss" not in metrics:
            metrics["proj_loss"] = torch.zeros((), device=metrics["denoising_loss"].device)
        total, sched = combine_losses(metrics, opt_step, curriculum)
        params = state.opt.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        grad_norm = global_norm(grads)
        state.opt.step(grads)
        period = accum_steps * max(1, curriculum.ema_every)
        if period == 1 or state.step % period == period - 1:
            ema_update(state.ema, state.model,
                       curriculum.ema_decay ** max(1, curriculum.ema_every))
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(sched, loss=total.detach(), grad_norm=grad_norm)
        return state, metrics

    return train_step
