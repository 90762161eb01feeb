"""RDM trainer: the latent DDPM over frozen-encoder representation
vectors, conditioned on the atom count. Counterpart of
reed_tpu/train/rdm.py (reference: molecule/models/engine_rdm.py
train_one_epoch, molecule/src/self_condition_train_{qm9,drug}_RDM.py):
AdamW with a cosine schedule, the x0-parameterised MSE, in f32, on one
device or over the data, fsdp and tensor axes of torch.distributed
(parallel/mesh.py; the tensor axis splits the residual blocks,
RDM_TP_RULES).

The step's draws (t, the noise and any dropout mask) come from the
trainer's device generator, seeded cfg.seed + 1, or are handed in; the
weights are initialised from a generator seeded cfg.seed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_weights
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.rdm import RDMConfig, RDMDiffusion
from reed_tpu_torch.models.rdm_mlp import SimpleMLP
from reed_tpu_torch.parallel.mesh import (RDM_AXES, RDM_TP_RULES, data_parallel, local_batch,
                                         shard_state_dict)


@dataclass(frozen=True)
class RDMTrainConfig:
    channels: int = 256
    model_channels: int = 1536
    bottleneck_channels: int = 1536
    num_res_blocks: int = 18
    time_embed_dim: int = 256
    max_nodes: int = 256
    dropout: float = 0.0
    rdm: RDMConfig = RDMConfig()
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0)
    batch_size: int = 128
    optim: OptimConfig = OptimConfig(lr=1e-4, weight_decay=0.005, schedule="cosine",
                                     warmup_steps=0, total_steps=200_000)
    mesh: MeshConfig = MeshConfig()
    seed: int = 0


def build_model(cfg: RDMTrainConfig, device=None,
                generator: Optional[torch.Generator] = None, parallel=None) -> SimpleMLP:
    """The configured SimpleMLP on `device`, initialised from `generator` as
    reed_tpu initialises it. Split over the tensor axis of `parallel` (a
    parallel.mesh.DataParallel): the whole model is initialised as one
    process does, then a tensor rank keeps its shards (RDM_TP_RULES)."""
    def simple_mlp(mesh=None):
        return SimpleMLP(in_channels=cfg.channels, time_embed_dim=cfg.time_embed_dim,
                         model_channels=cfg.model_channels,
                         bottleneck_channels=cfg.bottleneck_channels,
                         out_channels=cfg.channels, num_res_blocks=cfg.num_res_blocks,
                         dropout=cfg.dropout, use_context=True, num_classes=cfg.max_nodes,
                         context_channels=cfg.channels, parallel=mesh)

    with torch.device(device) if device is not None else torch.device("cpu"):
        model = simple_mlp().initialize_weights(generator)
        if parallel is not None and parallel.tensor > 1:
            whole, model = model, simple_mlp(parallel)
            model.load_state_dict(shard_state_dict(whole.state_dict(), parallel,
                                                   RDM_TP_RULES))
        return model


def rdm_config(cfg: RDMTrainConfig) -> RDMConfig:
    return replace(cfg.rdm, channels=cfg.channels)


def make_loss_fn(cfg: RDMTrainConfig, device=None):
    """loss_fn(model, batch, step, generator=None, t=None, noise=None) ->
    metrics: the batch mean of RDMDiffusion.training_loss over batch['rep']
    conditioned on batch['num_atoms'], with dropout in training. The
    schedule's tables go to `device` once, here, not on every step."""
    diffusion = RDMDiffusion(rdm_config(cfg), model_fn=None, device=device)

    def loss_fn(model, batch, step, generator=None, t=None, noise=None):
        del step

        def model_fn(x_t, tt, n_nodes):
            return model(x_t, tt, n_nodes, train=True, generator=generator)

        loss = diffusion.training_loss(batch["rep"], batch["num_atoms"], t=t, noise=noise,
                                       generator=generator, model_fn=model_fn).mean()
        return {"denoising_loss": loss, "proj_loss": torch.zeros((), device=loss.device)}

    return loss_fn


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy or CPU tensors): rep as f32, num_atoms as int64."""
    return {"rep": torch.as_tensor(batch["rep"], dtype=torch.float32).to(device),
            "num_atoms": torch.as_tensor(batch["num_atoms"]).long().to(device)}


class RDMTrainer:
    """reed_tpu's RDMTrainer: `init_state()`, then `train_step(state, batch,
    **draws) -> (state, metrics)` (in place), plus `synthetic_batch` and
    `diffusion(model)` for sampling. Under a process group (`self.dp`) a
    step takes this rank's rows of the global batch (`synthetic_batch`
    returns them) and its metrics are the global batch's; the tensor axis
    splits the model (build_model), and its ranks take the same rows and
    draws."""

    def __init__(self, cfg: RDMTrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=RDM_AXES)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        curriculum = replace(cfg.curriculum, max_steps=cfg.optim.total_steps)
        self._train_step = make_train_step(make_loss_fn(cfg, self.device), curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)

    def init_state(self) -> TrainState:
        model = build_model(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed), parallel=self.dp)
        # the replicated leaves' gradients are averaged over the tensor group,
        # so the tensor ranks' copies stay bitwise equal whatever order the
        # card's reductions (the class table's backward) take
        return init_train_state(model, self.cfg.optim, self.cfg.curriculum.ema_dtype, self.dp,
                                tp_rules=RDM_TP_RULES, sync_replicated=True)

    def train_step(self, state: TrainState, batch, **draws):
        return self._train_step(state, batch, generator=self.generator, **draws)

    def synthetic_batch(self, generator: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """reed_tpu's synthetic batch on the device: N(0, 1) reps and atom
        counts uniform in [5, max_nodes); this rank's rows of it under a
        process group."""
        bs = batch_size or self.cfg.batch_size
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        return local_batch(self.dp, {
            "rep": torch.randn((bs, self.cfg.channels), generator=generator,
                               device=self.device),
            "num_atoms": torch.randint(5, self.cfg.max_nodes, (bs,), generator=generator,
                                       device=self.device)})

    def ema_model(self, state: TrainState) -> SimpleMLP:
        """A whole model holding the state's EMA, in eval mode (under the
        fsdp or tensor axis a collective: the EMA is gathered and joined)."""
        model = build_model(self.cfg, device=self.device)
        plan = state.opt.plan
        model.load_state_dict(ema_weights(state) if plan is None else
                              plan.whole_named(state.ema))
        return model.eval()

    def diffusion(self, model: SimpleMLP) -> RDMDiffusion:
        """The RDM over `model` for sampling (no dropout)."""
        def model_fn(x_t, t, n_nodes):
            return model(x_t, t, n_nodes)

        return RDMDiffusion(rdm_config(self.cfg), model_fn, device=self.device)
