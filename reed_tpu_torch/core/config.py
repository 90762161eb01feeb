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
    mu_dtype: Optional[str] = None      # Adam first-moment dtype (None: f32)


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
    """reed_tpu's mesh axes, run over torch.distributed (parallel/mesh.py):
    data x fsdp x seq x tensor must be the world size (`data` None takes
    the rest), and the global batch splits over data x fsdp. The fsdp axis
    shards Adam's moments, the accumulation buffer and the EMA of every
    parameter that reed_tpu's fsdp_spec shards, those of at least 2
    dimensions and `fsdp_min_size` elements (None:
    parallel.mesh.FSDP_MIN_SIZE, 65536) with a dimension that fsdp divides
    (not the one the tensor rule takes). The tensor axis splits every
    trainer's model over groups of `tensor` ranks (Megatron; SemlaFlow's
    egnn and eqgat archs and the property linear probe run whole on every
    tensor rank), the seq axis SiT's tokens over groups of `seq` ranks;
    the eval subcommands raise on tensor above 1 (ROADMAP.md Queue 1 item
    11), and seq above 1 raises outside SiT (parallel.mesh.check_mesh,
    which each trainer calls)."""

    data: Optional[int] = None
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    fsdp_min_size: Optional[int] = None
