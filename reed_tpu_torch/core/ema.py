"""Exponential moving average of parameters, counterpart of
reed_tpu/core/ema.py. The EMA is a dict of tensors keyed by parameter name,
updated in place, in the shapes of the model's parameters (a tensor rank's
shards under the tensor axis). Under the fsdp axis (a
parallel.mesh.ShardPlan) each rank holds the chunks of the sharded
parameters only; `ema_weights` gathers them into the parameters' shapes."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def ema_init(model: nn.Module, dtype: Optional[str] = None,
             plan=None) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's parameters, in `dtype` if given (else
    the parameters' own, f32): this rank's chunks where `plan` shards."""
    dt = getattr(torch, dtype) if dtype else None
    out = {}
    for n, p in model.named_parameters():
        p = p.detach() if plan is None else plan.local_named(n, p.detach())
        out[n] = p.clone() if dt is None else p.to(dt).clone()
    return out


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float, plan=None):
    """ema <- ema * decay + params * (1 - decay), in the EMA's dtype (on
    this rank's chunks where `plan` shards: elementwise, so bitwise the
    slice of the whole update)."""
    names = list(ema)
    params = dict(model.named_parameters())
    ev = [ema[n] for n in names]
    pv = [(params[n] if plan is None else plan.local_named(n, params[n])).detach().to(
        ema[n].dtype) for n in names]
    torch._foreach_mul_(ev, decay)
    torch._foreach_add_(ev, pv, alpha=1.0 - decay)


def ema_weights(state) -> Dict[str, torch.Tensor]:
    """The EMA of a TrainState by parameter name in the shapes of the
    model's parameters: state.ema itself, or gathered over the fsdp group
    where state.opt.plan shards (a collective: every rank calls it)."""
    plan = state.opt.plan
    return state.ema if plan is None else plan.gather_named(state.ema)
