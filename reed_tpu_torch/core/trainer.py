"""The train step: loss, curriculum, optimizer and EMA, counterpart of
reed_tpu/core/trainer.py (make_train_step, combine_losses)."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from reed_tpu_torch.core.config import CurriculumConfig
from reed_tpu_torch.core.ema import ema_update
from reed_tpu_torch.core.schedules import diffusion_loss_decay, repa_weight_decay
from reed_tpu_torch.core.train_state import TrainState, global_norm
from reed_tpu_torch.parallel import draws

# lists that capture_gradients is filling
_gradient_sinks: List[list] = []


@contextlib.contextmanager
def capture_gradients():
    """Collect a copy of the gradients of every train step taken inside the
    block (after the data-parallel reduction, in parameter order), one list
    a step: what the update saw, for tests and diagnostics. Under the fsdp
    and tensor axes the whole gradients are gathered from the ranks' chunks
    and shards (a collective: every rank must capture)."""
    sink: list = []
    _gradient_sinks.append(sink)
    try:
        yield sink
    finally:
        _gradient_sinks.remove(sink)


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
                    accum_steps: int = 1, dp=None) -> Callable:
    """Build `train_step(state, batch, **inject) -> (state, metrics)`.

    loss_fn(model, batch, opt_step, **inject) -> metrics dict of scalar
    tensors with at least 'denoising_loss' ('proj_loss' is 0 when absent).
    The step updates `state` in place (parameters, optimizer, EMA, step) and
    returns it. With gradient accumulation `state.step` counts micro-steps:
    the curriculum sees the optimizer step step // accum_steps, and the EMA
    moves only on the micro-step that commits an update, and then only every
    `ema_every` optimizer steps with decay^ema_every (reed_tpu's semantics).
    Metrics add 'loss' (the combined total) and 'grad_norm' (of the
    micro-step's raw gradients). The optimizer and the EMA run inside
    profiler ranges ('reed::optimizer', 'reed::ema') that a torch.profiler
    trace attributes their kernels to.

    With `dp` (a parallel.mesh.DataParallel) the step runs this rank's rows
    of the global batch: the loss draws at the global shape and keeps the
    rows of its batch index (parallel/draws.py), the gradients are
    all-reduced (their mean over the replica group, the D x F x S ranks of
    one tensor index, in flat buckets) right after autograd, on every
    micro-step, so that grad_norm, the clip, Adam and the EMA see the
    global batch's gradient on every rank, and the loss metrics are
    averaged over the batch indices in one small all-reduce that stays on
    the device. Under seq every rank computes the whole loss and its
    gradient is S times its share (parallel/collectives.py), so the mean
    over the seq ranks is the loss's gradient. torch.nn.parallel.DistributedDataParallel would see nothing
    here: its hooks fire on .backward() into .grad, not on autograd.grad;
    nor would FSDP's wrappers or ZeroRedundancyOptimizer.

    Where the state has a ShardPlan (state.opt.plan, the fsdp or tensor
    axis) the step runs on this rank's share: the model holds its
    fsdp-sharded parameters as chunks (parallel/mesh.py, ShardPlan.attach),
    the rest of the model beside the units its modules gather is gathered
    around the loss (ShardPlan.gathered), autograd.grad differentiates with
    respect to the chunks, whose gradients the gathers' backward has
    reduced already, and the plan reduces the rest (reduce_grads);
    grad_norm, the clip, Adam and the EMA then run on the chunks and the
    tensor shards (grad_norm summing over the fsdp and tensor groups), and
    nothing is gathered after the update."""

    def train_step(state: TrainState, batch, **inject):
        opt_step = state.step // accum_steps
        plan = state.opt.plan
        with draws.global_rows(dp), (contextlib.nullcontext() if plan is None
                                     else plan.gathered()):
            metrics = dict(loss_fn(state.model, batch, opt_step, **inject))
        if "proj_loss" not in metrics:
            metrics["proj_loss"] = torch.zeros((), device=metrics["denoising_loss"].device)
        total, sched = combine_losses(metrics, opt_step, curriculum)
        params = state.opt.params
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        if plan is not None:
            grads = plan.reduce_grads(grads)
        elif dp is not None:
            grads = dp.all_reduce_grads(grads)
        if _gradient_sinks:
            whole = grads if plan is None else plan.whole(grads)
            for sink in _gradient_sinks:
                sink.append([g.detach().clone() for g in whole])
        grad_norm = global_norm(grads, plan)
        with record_function("reed::optimizer"):
            state.opt.step(grads, grad_norm)
        period = accum_steps * max(1, curriculum.ema_every)
        if period == 1 or state.step % period == period - 1:
            with record_function("reed::ema"):
                ema_update(state.ema, state.model,
                           curriculum.ema_decay ** max(1, curriculum.ema_every), plan)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(sched, loss=total.detach())
        if dp is not None:
            metrics = dp.mean_metrics(metrics)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
