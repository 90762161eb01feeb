"""Exponential moving average of parameters, counterpart of
reed_tpu/core/ema.py. The EMA is a dict of tensors keyed by parameter name,
updated in place."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def ema_init(model: nn.Module, dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's parameters, in `dtype` if given (else
    the parameters' own, f32)."""
    dt = getattr(torch, dtype) if dtype else None
    return {n: p.detach().clone() if dt is None else p.detach().to(dt).clone()
            for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float):
    """ema <- ema * decay + params * (1 - decay), in the EMA's dtype."""
    names = list(ema)
    params = dict(model.named_parameters())
    ev = [ema[n] for n in names]
    pv = [params[n].detach().to(ema[n].dtype) for n in names]
    torch._foreach_mul_(ev, decay)
    torch._foreach_add_(ev, pv, alpha=1.0 - decay)
