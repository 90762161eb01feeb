"""MultiFlow SE(3) codesign trainer: backbone and sequence flow matching.
Counterpart of reed_tpu/train/multiflow.py (reference:
protein/multiflow/models/flow_module.py:115-260 and
experiments/train_se3_flows.py).

One train step corrupts the batch (diffusion/se3.corrupt_batch: t, the
translation prior, IGSO3 rotation noise, masked tokens), runs the
FlowModel with zero self-conditioning, and takes the Lightning module's
losses: the t-normalised translation and rotation vector-field MSEs, the
backbone-atom and pairwise-distance auxiliary losses gated at t > 0.5, and
the aatype cross-entropy; Adam and the EMA follow (core/trainer.py). The
step's draws (`CorruptDraws`) come from the trainer's device generator,
seeded cfg.seed + 1, or are handed in. The batch-OT translation prior is
coupled on the host in the input pipeline (`synthetic_batch`,
data/protein.multiflow_epoch_batches). The port trains on one device, in
f32 or, with compute_dtype bfloat16, in bf16 over f32 parameters as
reed_tpu's `dtype` computes (models/ipa.py), or over the data, fsdp and
tensor axes of torch.distributed (parallel/mesh.py; the tensor axis splits
the IPA heads and the sequence transformer, `tp_rules`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_weights
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.se3 import (NUM_TOKENS, CorruptDraws, SE3InterpolantConfig,
                                          SE3SampleDraws, batch_ot_trans_prior, corrupt_batch,
                                          se3_sample)
from reed_tpu_torch.models.ipa import FlowModel, rigid_apply
from reed_tpu_torch.ops.residue_constants import RESTYPE_ATOM37_POSITIONS
from reed_tpu_torch.ops.so3 import calc_rot_vf, quat_to_rotmat
from reed_tpu_torch.parallel.mesh import (IPA_AXES, data_parallel, ipa_tp_rules, local_batch,
                                         shard_state_dict, whole_copy)

# the idealised N, CA, C positions in the residue frame (the ALA rigid
# group): the atoms of the reference's backbone-atom loss
# (flow_module.py:132,168 to_atom37(...)[:, :, :3])
IDEAL_BB = np.array(RESTYPE_ATOM37_POSITIONS[0, :3], np.float32)


def to_bb_atoms(rotmats, trans):
    """Rigids -> N, CA, C positions [B,N,3,3]."""
    ideal = torch.as_tensor(IDEAL_BB, dtype=rotmats.dtype, device=rotmats.device)
    return rigid_apply(rotmats, trans, ideal.expand(rotmats.shape[:-2] + (3, 3)))


@dataclass(frozen=True)
class MultiflowTrainConfig:
    c_s: int = 256
    c_z: int = 128
    num_blocks: int = 6
    seq_tfmr_num_layers: int = 2
    ipa_c_hidden: int = 16
    ipa_no_heads: int = 8
    ipa_no_qk_points: int = 8
    ipa_no_v_points: int = 12
    # losses (reference: configs/base.yaml:82-95)
    translation_loss_weight: float = 2.0
    rotation_loss_weight: float = 1.0
    aatypes_loss_weight: float = 1.0
    aux_loss_weight: float = 0.0
    aux_loss_t_pass: float = 0.5
    bb_atom_scale: float = 0.1
    trans_scale: float = 0.1
    t_normalize_clip: float = 0.9
    interpolant: SE3InterpolantConfig = SE3InterpolantConfig()
    batch_size: int = 4
    max_len: int = 128
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0)
    optim: OptimConfig = OptimConfig(lr=1e-4)
    mesh: MeshConfig = MeshConfig()
    compute_dtype: str = "float32"
    seed: int = 0


def check_config(cfg: MultiflowTrainConfig):
    """Raise on what the port does not run."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype!r}")


def tp_rules(cfg: MultiflowTrainConfig) -> tuple:
    """The tensor rules of the configured FlowModel (parallel/mesh.ipa_tp_rules
    at its IPA widths)."""
    return ipa_tp_rules(cfg.ipa_no_heads, cfg.ipa_c_hidden, cfg.ipa_no_v_points, cfg.c_z)


def build_model(cfg: MultiflowTrainConfig, device=None,
                generator: Optional[torch.Generator] = None, parallel=None) -> FlowModel:
    """The configured FlowModel on `device`, initialised from `generator` as
    reed_tpu initialises it. Split over the tensor axis of `parallel` (a
    parallel.mesh.DataParallel): the whole model is initialised as one
    process does, then a tensor rank keeps its shards (tp_rules)."""
    check_config(cfg)

    def flow_model(mesh=None):
        return FlowModel(c_s=cfg.c_s, c_z=cfg.c_z, num_blocks=cfg.num_blocks,
                         seq_tfmr_num_layers=cfg.seq_tfmr_num_layers,
                         ipa_c_hidden=cfg.ipa_c_hidden, ipa_no_heads=cfg.ipa_no_heads,
                         ipa_no_qk_points=cfg.ipa_no_qk_points,
                         ipa_no_v_points=cfg.ipa_no_v_points, aatype_pred_num_tokens=NUM_TOKENS,
                         compute_dtype=getattr(torch, cfg.compute_dtype), parallel=mesh)

    with torch.device(device) if device is not None else torch.device("cpu"):
        model = flow_model().initialize_weights(generator)
        if parallel is not None and parallel.tensor > 1:
            whole, model = model, flow_model(parallel)
            model.load_state_dict(shard_state_dict(whole.state_dict(), parallel,
                                                   tp_rules(cfg)))
        return model


def multiflow_losses(cfg: MultiflowTrainConfig, noisy: Dict, out: Dict) -> Dict:
    """The reference's model_step losses (flow_module.py:115-240), each a
    batch mean."""
    loss_mask = noisy["res_mask"]
    loss_denom = torch.sum(loss_mask, -1) * 3
    r3_t, so3_t = noisy["r3_t"], noisy["so3_t"]
    clip = cfg.t_normalize_clip
    r3_norm = 1 - torch.clamp(r3_t[..., None], max=clip)      # [B,1,1]
    so3_norm = 1 - torch.clamp(so3_t[..., None], max=clip)

    gt_rot_vf = calc_rot_vf(noisy["rotmats_t"], noisy["rotmats_1"])
    pred_rot_vf = calc_rot_vf(noisy["rotmats_t"], out["pred_rotmats"])

    # aatype cross-entropy
    logp = torch.log_softmax(out["pred_logits"], -1)
    ce = -torch.gather(logp, -1, noisy["aatypes_1"][..., None].long())[..., 0]
    aatypes_loss = torch.sum(ce * loss_mask, -1) / (loss_denom / 3) * cfg.aatypes_loss_weight

    # translation vector field (x1 parameterisation), clipped
    trans_err = (noisy["trans_1"] - out["pred_trans"]) / r3_norm * cfg.trans_scale
    trans_loss = cfg.translation_loss_weight * torch.sum(
        trans_err ** 2 * loss_mask[..., None], (-1, -2)) / loss_denom
    trans_loss = torch.clamp(trans_loss, max=5.0)

    # rotation vector field
    rot_err = (gt_rot_vf - pred_rot_vf) / so3_norm
    rots_loss = cfg.rotation_loss_weight * torch.sum(
        rot_err ** 2 * loss_mask[..., None], (-1, -2)) / loss_denom

    # backbone-atom and pairwise-distance auxiliary losses
    gt_bb = to_bb_atoms(noisy["rotmats_1"], noisy["trans_1"])
    pred_bb = to_bb_atoms(out["pred_rotmats"], out["pred_trans"])
    scale = cfg.bb_atom_scale / r3_norm[..., None]
    bb_loss = torch.sum(((gt_bb - pred_bb) * scale) ** 2 * loss_mask[..., None, None],
                        (-1, -2, -3)) / loss_denom

    b, n = loss_mask.shape
    gt_flat = gt_bb.reshape(b, n * 3, 3)
    pred_flat = pred_bb.reshape(b, n * 3, 3)
    # 1e-8 on the difference vector, not under the root, as the reference
    gt_d = torch.linalg.vector_norm(gt_flat[:, :, None] - gt_flat[:, None] + 1e-8, dim=-1)
    pred_d = torch.linalg.vector_norm(pred_flat[:, :, None] - pred_flat[:, None] + 1e-8, dim=-1)
    flat_mask = torch.repeat_interleave(loss_mask, 3, dim=-1)
    pair_mask = flat_mask[:, :, None] * flat_mask[:, None, :]
    dist_loss = torch.sum((gt_d - pred_d) ** 2 * pair_mask, (1, 2)) / (
        torch.sum(pair_mask, (1, 2)) + 1)

    gate = ((r3_t[:, 0] > cfg.aux_loss_t_pass) & (so3_t[:, 0] > cfg.aux_loss_t_pass)).float()
    aux = torch.clamp((bb_loss + dist_loss) * gate * cfg.aux_loss_weight, max=5.0)

    total = trans_loss + rots_loss + aux + aatypes_loss
    return {"denoising_loss": total.mean(), "trans_loss": trans_loss.mean(),
            "rots_vf_loss": rots_loss.mean(), "aatypes_loss": aatypes_loss.mean(),
            "aux_loss": aux.mean(), "proj_loss": torch.zeros((), device=total.device)}


def make_loss_fn(cfg: MultiflowTrainConfig):
    """loss_fn(model, batch, step, generator=None, draws=None) -> metrics:
    corrupt the batch (with `draws`, else drawing from `generator`), run
    the model with zero self-conditioning, and take multiflow_losses."""

    def loss_fn(model, batch, step, generator=None, draws: Optional[CorruptDraws] = None):
        del step
        noisy = corrupt_batch(cfg.interpolant, batch, draws, generator)
        noisy["trans_sc"] = torch.zeros_like(noisy["trans_t"])
        noisy["aatypes_sc"] = F.one_hot(noisy["aatypes_t"], NUM_TOKENS).float()
        return multiflow_losses(cfg, noisy, model(noisy))

    return loss_fn


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors) on `device`: the tokens and
    residue indices as int64, the rest as f32."""
    ints = ("aatypes_1", "res_idx")
    return {k: torch.as_tensor(v, dtype=torch.long if k in ints else torch.float32).to(
        device, non_blocking=True) for k, v in batch.items()}


def synthetic_host_batch(rng: np.random.Generator, batch_size: int, length: int,
                         trans_batch_ot: bool = False, trans_scale: float = 10.0
                         ) -> Dict[str, np.ndarray]:
    """reed_tpu's synthetic batch schema from a numpy generator: random-walk
    CA traces (steps N(0, 1.5^2), centred), uniform rotations, random tokens
    in [0, 20), full masks; with trans_batch_ot the coupled prior trans_0."""
    steps = rng.standard_normal((batch_size, length, 3)).astype(np.float32) * 1.5
    trans = np.cumsum(steps, axis=1)
    trans = trans - trans.mean(axis=1, keepdims=True)
    q = rng.standard_normal((batch_size, length, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mask = np.ones((batch_size, length), np.float32)
    batch = {
        "trans_1": trans.astype(np.float32),
        "rotmats_1": quat_to_rotmat(torch.from_numpy(q)).numpy().astype(np.float32),
        "aatypes_1": rng.integers(0, 20, (batch_size, length)),
        "res_mask": mask,
        "res_idx": np.broadcast_to(np.arange(length)[None], (batch_size, length)).copy(),
    }
    if trans_batch_ot:
        batch["trans_0"] = batch_ot_trans_prior(rng, trans, mask, trans_scale)
    return batch


class MultiflowTrainer:
    """reed_tpu's MultiflowTrainer: `init_state()`, then `train_step(state,
    batch, draws=None) -> (state, metrics)` (in place), plus
    `synthetic_batch`, `ema_model` and `sample`. Weights are initialised
    from a generator seeded cfg.seed (the same on every rank); the training
    draws come from `self.generator`, a device generator seeded cfg.seed +
    1. Under a process group (`self.dp`) a step takes this rank's rows of a
    global host batch built as one process builds it (the batch-OT prior
    included; `synthetic_batch` returns them) and its metrics are the
    global batch's; the tensor axis splits the model (build_model), and its
    ranks take the same rows and draws."""

    def __init__(self, cfg: MultiflowTrainConfig, device=None):
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=IPA_AXES)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        curriculum = replace(cfg.curriculum, max_steps=cfg.optim.total_steps)
        self._train_step = make_train_step(make_loss_fn(cfg), curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)
        self._ema_model = None

    def init_state(self) -> TrainState:
        model = build_model(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed), parallel=self.dp)
        # the replicated leaves' gradients are averaged over the tensor group,
        # so the tensor ranks' copies stay bitwise equal whatever order the
        # card's reductions (the embedding tables' backward) take
        return init_train_state(model, self.cfg.optim, self.cfg.curriculum.ema_dtype, self.dp,
                                tp_rules=tp_rules(self.cfg), sync_replicated=True)

    def train_step(self, state: TrainState, batch, draws: Optional[CorruptDraws] = None):
        return self._train_step(state, batch, generator=self.generator, draws=draws)

    def synthetic_batch(self, rng: Optional[np.random.Generator] = None,
                        batch_size: Optional[int] = None,
                        length: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A synthetic batch (synthetic_host_batch, numpy generator `rng`,
        default seed 1) on the device, with the batch-OT prior coupled on
        the host when the interpolant asks for it; this rank's rows of it
        under a process group."""
        cfg = self.cfg
        host = synthetic_host_batch(rng if rng is not None else np.random.default_rng(1),
                                    batch_size or cfg.batch_size, length or cfg.max_len,
                                    cfg.interpolant.trans_batch_ot, cfg.interpolant.trans_scale)
        return batch_to_device(local_batch(self.dp, host), self.device)

    def ema_model(self, state: TrainState) -> FlowModel:
        """A copy of the model (kept for reuse) holding the state's EMA."""
        if self._ema_model is None:
            self._ema_model = whole_copy(state.model, state.opt.plan)
        with torch.no_grad():
            ema = ema_weights(state)
            for name, p in self._ema_model.named_parameters():
                p.copy_(ema[name])
        return self._ema_model

    @torch.no_grad()
    def sample(self, model: FlowModel, batch_size: int, length: int,
               num_timesteps: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               draws: Optional[SE3SampleDraws] = None) -> Dict[str, torch.Tensor]:
        """Euler-sample batch_size backbones and sequences of `length`
        residues from `model` (se3_sample), drawing from `generator`."""
        return sample(self.cfg, model, torch.ones((batch_size, length), device=self.device),
                      num_timesteps=num_timesteps, generator=generator, draws=draws)


@torch.no_grad()
def sample(cfg: MultiflowTrainConfig, model: FlowModel, res_mask: torch.Tensor,
           num_timesteps: Optional[int] = None, generator: Optional[torch.Generator] = None,
           draws: Optional[SE3SampleDraws] = None) -> Dict[str, torch.Tensor]:
    """se3_sample of the backbones and sequences of res_mask [B, N] from
    `model` (split over its tensor ranks where it was built so), drawing
    from `generator` or taking `draws`. Inside draws.global_rows res_mask
    is this rank's rows of the global batch, and the draws are made (or
    given) at the global batch."""
    return se3_sample(cfg.interpolant, model, tuple(res_mask.shape), res_mask,
                      num_timesteps=num_timesteps, draws=draws, generator=generator)
