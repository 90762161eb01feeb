"""Typed training configuration, counterpart of reed_tpu/core/config.py
(OptimConfig, CurriculumConfig, MeshConfig)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None   # max global grad norm
    schedule: str = "constant"          # constant | onecycle | cosine
    warmup_steps: int = 0
    total_steps: int = 1_000_000
    accum_steps: int = 1                # gradient accumulation (as optax.MultiSteps)
    mu_dtype: Optional[str] = None      # Adam first-moment dtype: not ported


@dataclass(frozen=True)
class CurriculumConfig:
    """REED curriculum (reference: image/train.py:362-398)."""

    proj_coeff: float = 0.5
    repa_decay: str = "constant"        # constant | linear | cosine
    repa_steps: int = 1_000_000
    start_diffusion_steps: int = 0
    diffusion_warmup_steps: int = 50_000
    diffusion_decay: str = "constant"   # constant | linear | cosine
    max_steps: int = 1_000_000
    ema_decay: float = 0.9999
    ema_dtype: Optional[str] = None     # EMA dtype; None keeps the params' (f32)
    ema_every: int = 1                  # EMA every k optimizer steps with decay^k


@dataclass(frozen=True)
class MeshConfig:
    """Kept so that reed_tpu's configurations load. The port trains on one
    device: a trainer raises when this asks for more."""

    data: Optional[int] = None
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    fsdp_min_size: Optional[int] = None

    def check_single_device(self):
        if any(n not in (None, 1) for n in (self.data, self.fsdp, self.tensor, self.seq)):
            raise NotImplementedError(
                f"the port trains on one device; mesh {self} asks for more "
                "(multi-GPU training is not ported yet)")
