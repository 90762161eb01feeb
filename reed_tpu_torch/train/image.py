"""Image-domain trainer: SiT flow matching with REED alignment, counterpart
of reed_tpu/train/image.py, on one device or over torch.distributed's
(data, fsdp, seq, tensor) mesh (parallel/mesh.py): under tensor each rank
holds its shards of SiT's blocks (SIT_TP_RULES) and their Adam state and
EMA, under seq its slice of the tokens.

One train step draws t, eps and the CFG label drops, runs SiT in its
compute dtype (bf16 by default) with f32 master weights cast where they
are used, takes the f32 flow-matching loss plus the projector alignment
weighted by the curriculum, and applies Adam (optionally with a bf16 first
moment, `OptimConfig.mu_dtype`) and the f32 EMA (core/trainer.py). On the
card each block's attention runs forward through the CUDA kernel K1 and
backward through the plain recompute (ops/flash_attention.py); with
cfg.remat the blocks are checkpointed (models/sit.py) and K1 runs again in
the backward's recompute, two launches a block a step. Random draws come
from torch.Generators; reed_tpu's come from JAX keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.continuous import FlowMatchingLossConfig, flow_matching_loss
from reed_tpu_torch.models.sit import SiT, create_sit
from reed_tpu_torch.parallel.mesh import (SIT_AXES, SIT_TP_RULES, data_parallel, local_batch,
                                         shard_state_dict)

# reed_tpu's attn_impl names -> the port's SiT choice: the kernel K1 on
# CUDA tensors, or plain attention
ATTN_IMPLS = {"auto": "auto", "pallas": "auto", "xla": "reference"}


@dataclass(frozen=True)
class ImageTrainConfig:
    model: str = "SiT-B/2"
    input_size: int = 32
    in_channels: int = 4
    num_classes: int = 1000
    encoder_depth: int = 8
    encoder_depth_text: Optional[int] = None
    z_dims: Sequence[int] = (768,)
    z_types: Sequence[str] = ("i",)
    projector_dim: int = 2048
    class_dropout_prob: float = 0.1
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"
    remat: Any = False  # False | True | 'dots' | a policy name (models/sit.py)
    exact_gelu: bool = False  # erf GELU, required for torch-checkpoint parity
    batch_size: int = 256
    loss: FlowMatchingLossConfig = FlowMatchingLossConfig()
    optim: OptimConfig = OptimConfig(lr=1e-4)
    curriculum: CurriculumConfig = CurriculumConfig()
    mesh: MeshConfig = MeshConfig()
    seed: int = 0


def build_model(cfg: ImageTrainConfig, device=None,
                generator: Optional[torch.Generator] = None, parallel=None) -> SiT:
    """The configured SiT on `device` with f32 parameters initialised from
    `generator` (reed_tpu's initialisation), computing in cfg.compute_dtype,
    its blocks checkpointed as cfg.remat asks, split over the seq and
    tensor axes of `parallel` (a parallel.mesh.DataParallel): the whole
    model is initialised as one process does, then a tensor rank keeps its
    shards. Raises ValueError on an unknown attn_impl or remat policy, and
    where the tensor size does not divide the heads or seq the tokens."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {sorted(ATTN_IMPLS)}, "
                         f"got {cfg.attn_impl!r}")

    def create(mesh):
        return create_sit(
            cfg.model, device=device,
            input_size=cfg.input_size, in_channels=cfg.in_channels,
            num_classes=cfg.num_classes, encoder_depth=cfg.encoder_depth,
            encoder_depth_text=cfg.encoder_depth_text, z_dims=tuple(cfg.z_dims),
            z_types=tuple(cfg.z_types), projector_dim=cfg.projector_dim,
            class_dropout_prob=cfg.class_dropout_prob,
            attn_impl=ATTN_IMPLS[cfg.attn_impl], exact_gelu=cfg.exact_gelu,
            compute_dtype=getattr(torch, cfg.compute_dtype), remat=cfg.remat,
            parallel=mesh)

    tensor = parallel is not None and parallel.tensor > 1
    model = create(parallel)  # raises first where the mesh does not fit
    if tensor:
        whole = create(None)
        whole.initialize_weights(generator)
        model.load_state_dict(shard_state_dict(whole.state_dict(), parallel, SIT_TP_RULES))
        del whole
    else:
        model.initialize_weights(generator)
    return model.eval()


def make_loss_fn(loss_cfg: FlowMatchingLossConfig):
    """loss_fn(model, batch, step, generator=None, t=None, eps=None,
    drop=None) -> metrics, reed_tpu's image loss. t, eps and the CFG label
    drops are drawn from `generator` unless given (a test hands over
    reed_tpu's)."""

    def loss_fn(model, batch, step, generator=None, t=None, eps=None, drop=None):
        del step

        def model_fn(x_t, tt, y):
            return model(x_t, tt, y, train=True, drop=drop, generator=generator)

        return flow_matching_loss(loss_cfg, model_fn, batch["x"], batch["zs"],
                                  generator=generator, model_kwargs={"y": batch["y"]},
                                  t=t, eps=eps)

    return loss_fn


def batch_to_device(batch, device: torch.device):
    """A batch of numpy arrays or tensors ({'x', 'y', 'zs': [...]}) as
    tensors on `device`: x and zs f32, y int64."""
    def put(a, dtype):
        t = torch.from_numpy(a) if isinstance(a, np.ndarray) else torch.as_tensor(a)
        return t.to(device=device, dtype=dtype)

    return {"x": put(batch["x"], torch.float32), "y": put(batch["y"], torch.int64),
            "zs": [put(z, torch.float32) for z in batch["zs"]]}


class ImageTrainer:
    """reed_tpu's ImageTrainer: `init_state()`, then `train_step(state,
    batch, **inject) -> (state, metrics)` (in place), `synthetic_batch` and
    `run`. Weights are initialised from a generator seeded cfg.seed (the
    same on every rank); the training draws come from `self.generator`,
    seeded cfg.seed + 1. Under a process group (`self.dp`) a step takes
    this rank's rows of the global batch of cfg.batch_size
    (`synthetic_batch` returns them) and its metrics are the global
    batch's."""

    def __init__(self, cfg: ImageTrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=SIT_AXES)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._train_step = make_train_step(make_loss_fn(cfg.loss), cfg.curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)

    def init_state(self) -> TrainState:
        model = build_model(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed), parallel=self.dp)
        return init_train_state(model, self.cfg.optim, self.cfg.curriculum.ema_dtype, self.dp,
                                tp_rules=SIT_TP_RULES)

    def train_step(self, state: TrainState, batch, t=None, eps=None, drop=None):
        """One step on a batch (numpy or tensors, moved to the trainer's
        device; this rank's rows under a process group); t, eps and drop as
        in make_loss_fn, for the same rows."""
        return self._train_step(state, batch_to_device(batch, self.device),
                                generator=self.generator, t=t, eps=eps, drop=drop)

    def synthetic_batch(self, generator: Optional[torch.Generator] = None):
        """A random batch of cfg.batch_size with the training schema on the
        trainer's device (this rank's rows of it under a process group):
        N(0, 1) latents, uniform labels and N(0, 1) encoder targets (per
        token for 'i', pooled for 't'), a stand-in for cached VAE latents
        and encoder features."""
        cfg = self.cfg
        bs = cfg.batch_size
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        num_tokens = (cfg.input_size // _patch(cfg.model)) ** 2
        x = torch.randn((bs, cfg.input_size, cfg.input_size, cfg.in_channels),
                        generator=generator, device=self.device)
        y = torch.randint(0, cfg.num_classes, (bs,), generator=generator,
                          device=self.device)
        zs = [torch.randn((bs, num_tokens, z_dim) if z_type == "i" else (bs, z_dim),
                          generator=generator, device=self.device)
              for z_dim, z_type in zip(cfg.z_dims, cfg.z_types)]
        return local_batch(self.dp, {"x": x, "y": y, "zs": zs})

    def run(self, state: TrainState, batches, log_every: int = 100, log_fn=print):
        """A host loop over an iterable of batches, logging the metrics as
        floats every `log_every` steps."""
        for i, batch in enumerate(batches):
            state, metrics = self.train_step(state, batch)
            if log_fn is not None and (i + 1) % log_every == 0:
                log_fn({k: float(v) for k, v in metrics.items()})
        return state


def _patch(model_name: str) -> int:
    return int(model_name.rsplit("/", 1)[1])
