"""SemlaFlow molecule trainer: equivariant flow matching with
self-conditioning and REED representation alignment. Counterpart of
reed_tpu/train/molecule_semla.py (reference: MolecularCFM,
molecule/semlaflow/flowmodels/fm.py:362-1010).

One train step runs the coordinate MSE and the type / bond / charge CE
losses (with the mask strategies), the diffusion-loss warm-up to
`diffusion_loss_max_step`, the REPA cosine alignment of the sum-pooled
projected activations against a frozen-encoder global rep, and on half of
the steps a self-conditioning pass without gradients; Adam with a
global-norm clip and the EMA follow (core/trainer.py). Batches are built on
the host (prior, OT coupling and interpolation in numpy, as reed_tpu's and
the reference's collate) and moved with `batch_to_device`. The
self-conditioning coin is drawn on the host from the trainer's CPU
generator (reed_tpu draws it inside its jit), so the step never waits for
the device. Generation is the Euler integrator in a Python loop on the
device. The port trains in f32 or, with compute_dtype bfloat16, in
reed_tpu's mixed precision (bf16 features and messages, f32 coordinates,
f32 parameters and optimizer), on one device or over torch.distributed's
ranks (data and fsdp axes; with arch semla also the tensor axis,
parallel/mesh.SEMLA_TP_RULES: every tensor rank of a batch index takes the
same rows, prior, OT assignment, times, noise, coin and REPA targets, and
computes the whole loss). `arch` egnn and eqgat swap the SemlaGenerator for
models/semla_alt.py's generators; EQGAT has no alignment projectors, so
its proj_loss is 0, as reed_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_weights
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.molecule_fm import (IntegratorConfig,
                                                  MoleculeInterpolantConfig,
                                                  integrator_step, interpolate_batch,
                                                  sample_prior_batch)
from reed_tpu_torch.models.semla import SemlaGenerator, adj_from_node_mask
from reed_tpu_torch.models.semla_alt import EqgatGenerator, VanillaEgnnGenerator
from reed_tpu_torch.parallel.mesh import (SEMLA_AXES, SEMLA_TP_RULES, data_parallel,
                                         shard_state_dict, whole_copy)


@dataclass(frozen=True)
class SemlaTrainConfig:
    arch: str = "semla"              # semla | egnn | eqgat (train.py:120-160)
    vocab_size: int = 18
    n_bond_types: int = 5
    n_charge_types: int = 7
    max_atoms: int = 256
    d_model: int = 384
    d_message: int = 128
    n_layers: int = 12
    n_coord_sets: int = 64
    d_message_hidden: int = 128
    d_edge: int = 128
    n_attn_heads: int = 32
    size_emb: int = 64
    self_cond: bool = True
    # rep conditioning / alignment
    d_rep: Optional[int] = 512
    cond_type: str = "none"          # none | cross_attn | adaLN
    rep_alignment: bool = True
    align_depth: Sequence[int] = (4,)
    repa_loss_weight: float = 0.2
    # losses
    type_strategy: str = "ce"        # ce | mse | mask
    bond_strategy: str = "ce"        # ce | mask
    # the reference recipe's defaults (semlaflow/train.py:51-62): type loss
    # weighted 0.2, training coordinate noise 0.2 A, sampling-time
    # categorical noise level 1
    type_loss_weight: float = 0.2
    bond_loss_weight: float = 1.0
    charge_loss_weight: float = 1.0
    diffusion_loss_max_step: int = 0
    # interpolant / integrator
    interpolant: MoleculeInterpolantConfig = MoleculeInterpolantConfig(
        coord_noise_std=0.2)
    integrator: IntegratorConfig = IntegratorConfig(cat_noise_level=1.0)
    batch_size: int = 64
    # grad_clip 1.0 = the reference's (semlaflow/train.py:50)
    optim: OptimConfig = OptimConfig(lr=3e-4, schedule="constant", grad_clip=1.0)
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.2,
                                                    diffusion_warmup_steps=0)
    mesh: MeshConfig = MeshConfig()
    compute_dtype: str = "float32"
    # residual coordinate head (x1_hat = x_t + delta); adds no parameters
    coord_skip: bool = False
    seed: int = 0


def check_config(cfg: SemlaTrainConfig):
    """Raise on an architecture or a compute dtype the port does not run."""
    if cfg.arch not in ("semla", "egnn", "eqgat"):
        raise ValueError(f"arch must be semla, egnn or eqgat, got {cfg.arch!r}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype!r}")


def build_model(cfg: SemlaTrainConfig, device=None,
                generator: Optional[torch.Generator] = None, parallel=None) -> nn.Module:
    """The configured generator on `device` (f32 parameters, computing in
    cfg.compute_dtype: bfloat16 is reed_tpu's mixed precision), initialised
    from `generator` as reed_tpu initialises it: SemlaGenerator, or with
    arch egnn / eqgat the generators of models/semla_alt.py, built with
    reed_tpu's arguments (reference: semlaflow/train.py:120-160). Split over
    the tensor axis of `parallel` (a parallel.mesh.DataParallel; arch semla
    only): the whole model is initialised as one process does, then a
    tensor rank keeps its shards (SEMLA_TP_RULES)."""
    check_config(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    common = dict(d_model=cfg.d_model, vocab_size=cfg.vocab_size, n_atom_feats=cfg.vocab_size,
                  d_edge=cfg.d_edge, n_edge_types=cfg.n_bond_types,
                  n_charge_types=cfg.n_charge_types, n_layers=cfg.n_layers,
                  self_cond=cfg.self_cond, d_rep=cfg.d_rep, compute_dtype=dtype)
    semla = dict(size_emb=cfg.size_emb, max_atoms=cfg.max_atoms,
                 rep_alignment=cfg.rep_alignment, d_message=cfg.d_message,
                 n_coord_sets=cfg.n_coord_sets, n_attn_heads=cfg.n_attn_heads,
                 d_message_hidden=cfg.d_message_hidden, cond_type=cfg.cond_type,
                 align_depth=tuple(cfg.align_depth), coord_skip=cfg.coord_skip, **common)
    with torch.device(device) if device is not None else torch.device("cpu"):
        if cfg.arch == "egnn":
            model = VanillaEgnnGenerator(rep_alignment=cfg.rep_alignment,
                                         align_depth=tuple(cfg.align_depth), **common)
        elif cfg.arch == "eqgat":
            model = EqgatGenerator(**common)
        else:
            model = SemlaGenerator(**semla)
        model.initialize_weights(generator)
        if cfg.arch == "semla" and parallel is not None and parallel.tensor > 1:
            whole, model = model, SemlaGenerator(**semla, parallel=parallel)
            model.load_state_dict(shard_state_dict(whole.state_dict(), parallel,
                                                   SEMLA_TP_RULES))
        return model


def batch_to_device(batch: Dict, device) -> Dict:
    """A host batch (nested dicts of numpy arrays or CPU tensors) as tensors
    on `device`, without the prior, which the train step does not read.
    From pinned tensors the copies do not wait for the device."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return torch.as_tensor(v).to(device, non_blocking=True)

    return {k: move(v) for k, v in batch.items() if k != "prior"}


def _ce(logits, onehot):
    """-log_softmax(logits)[argmax(onehot)] per position."""
    labels = torch.argmax(onehot, dim=-1, keepdim=True)
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels)[..., 0]


def semla_losses(cfg: SemlaTrainConfig, data, interpolated, predicted, eps: float = 1e-3):
    """Coordinate MSE and type / bond / charge CE (reference:
    fm.py:842-905,966); each a batch mean, times its weight."""
    mask = data["mask"]
    mask2 = mask[..., None]
    coord_loss = ((predicted["coords"] - data["coords"]) ** 2 * mask2).mean(dim=(1, 2))

    pred_logits = predicted["atomics"]
    if cfg.type_strategy == "mse":
        # summed over the vocab dim, divided by the atom count only (fm.py:853-858)
        type_loss = ((pred_logits - data["atomics"]) ** 2 * mask2).sum(dim=(1, 2)) \
            / (mask.sum(-1) + eps)
    else:
        tl = _ce(pred_logits, data["atomics"])
        n_atoms = mask.sum(-1) + eps
        if cfg.type_strategy == "mask":
            masked = (torch.argmax(interpolated["atomics"], dim=-1)
                      == cfg.integrator.type_mask_index)
            n_atoms = masked.sum(-1) + eps
            tl = tl * masked
        type_loss = (tl * mask).sum(-1) / n_atoms

    # bonds include the self-connections (adj_from_node_mask(self_connect=True))
    bl = _ce(predicted["bonds"], data["bonds"])
    adj = adj_from_node_mask(mask, self_connect=True)
    n_bonds = adj.sum(dim=(1, 2)) + eps
    if cfg.bond_strategy == "mask":
        masked_b = (torch.argmax(interpolated["bonds"], dim=-1)
                    == cfg.integrator.bond_mask_index)
        n_bonds = masked_b.sum(dim=(1, 2)) + eps
        bl = bl * masked_b
    bond_loss = (bl * adj).sum(dim=(1, 2)) / n_bonds

    cl = _ce(predicted["charges"], data["charges"])
    charge_loss = (cl * mask).sum(-1) / (mask.sum(-1) + eps)
    return {
        "coord_loss": coord_loss.mean(),
        "type_loss": type_loss.mean() * cfg.type_loss_weight,
        "bond_loss": bond_loss.mean() * cfg.bond_loss_weight,
        "charge_loss": charge_loss.mean() * cfg.charge_loss_weight,
    }


def _apply(model, cfg, state, times, cond, rep):
    """The model on an interpolated state, with the self-conditioning inputs
    where cfg.self_cond."""
    sc = cfg.self_cond
    return model(state["coords"], state["atomics"], edge_feats=state["bonds"],
                 cond_coords=cond["coords"] if sc else None,
                 cond_atomics=cond["atomics"] if sc else None,
                 cond_bonds=cond["bonds"] if sc else None,
                 atom_mask=state["mask"], rep=rep, times=times)


def _zero_cond(state):
    return {k: torch.zeros_like(state[k]) for k in ("coords", "atomics", "bonds")}


def make_loss_fn(cfg: SemlaTrainConfig):
    """loss_fn(model, batch, step, generator=None, use_sc=None) -> metrics,
    reed_tpu's SemlaFlow loss. With cfg.self_cond, half of the steps first
    run the model without gradients and feed its prediction back as the
    self-conditioning input: the coin is `use_sc` where given, else
    uniform > 0.5 drawn from `generator` (a CPU generator: no device
    sync)."""

    def loss_fn(model, batch, step, generator=None, use_sc=None):
        del step
        data, interpolated, times = batch["data"], batch["interpolated"], batch["times"]
        rep = batch.get("rep") if cfg.cond_type != "none" else None
        z_rep = batch.get("rep") if cfg.rep_alignment else None
        cond = _zero_cond(interpolated)
        if cfg.self_cond:
            if use_sc is None:
                use_sc = bool(torch.rand((), generator=generator) > 0.5)
            if use_sc:
                with torch.no_grad(), record_function("reed::self_cond"):
                    c, t_logits, b_logits, _, _ = _apply(model, cfg, interpolated,
                                                         times, cond, rep)
                    cond = {"coords": c, "atomics": torch.softmax(t_logits, dim=-1),
                            "bonds": torch.softmax(b_logits, dim=-1)}
        with record_function("reed::model"):
            coords, type_logits, bond_logits, charge_logits, zs = _apply(
                model, cfg, interpolated, times, cond, rep)
        with record_function("reed::loss"):
            predicted = {"coords": coords, "atomics": type_logits, "bonds": bond_logits,
                         "charges": charge_logits}
            losses = semla_losses(cfg, data, interpolated, predicted)
            metrics = {**losses, "denoising_loss": sum(losses.values())}
            if cfg.rep_alignment and z_rep is not None and zs:
                zn = z_rep / (torch.linalg.vector_norm(z_rep, dim=-1, keepdim=True) + 1e-8)
                proj = 0.0
                for z_j in zs:
                    zjn = z_j / (torch.linalg.vector_norm(z_j, dim=-1, keepdim=True) + 1e-8)
                    proj = proj - (zjn * zn).sum(-1)
                metrics["proj_loss"] = (proj / len(zs)).mean()
            else:
                metrics["proj_loss"] = torch.zeros((), device=coords.device)
        return metrics

    return loss_fn


def example_batch(cfg: SemlaTrainConfig, batch_size: int, max_n: int = 16,
                  seed: int = 0) -> Dict:
    """A synthetic batch of the training schema, host numpy (the prior, the
    OT coupling and the interpolation happen on the host, as the
    reference's collate); for one seed the arrays of reed_tpu's
    example_batch."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(max(2, max_n // 2), max_n + 1, size=batch_size)
    mask = (np.arange(max_n)[None, :] < sizes[:, None]).astype(np.float32)
    coords = rng.standard_normal((batch_size, max_n, 3)).astype(np.float32)
    coords = coords * mask[..., None]
    types = rng.integers(0, cfg.vocab_size, size=(batch_size, max_n))
    atomics = np.eye(cfg.vocab_size, dtype=np.float32)[types] * mask[..., None]
    bonds_idx = rng.integers(0, cfg.n_bond_types, size=(batch_size, max_n, max_n))
    bonds_idx = np.triu(bonds_idx, 1) + np.triu(bonds_idx, 1).transpose(0, 2, 1)
    bonds = np.eye(cfg.n_bond_types, dtype=np.float32)[bonds_idx]
    charges_idx = rng.integers(0, cfg.n_charge_types, size=(batch_size, max_n))
    charges = np.eye(cfg.n_charge_types, dtype=np.float32)[charges_idx]
    data = {"coords": coords, "atomics": atomics, "bonds": bonds, "charges": charges,
            "mask": mask}
    prior, interpolated, times = interpolate_batch(rng, cfg.interpolant, data)
    batch = {"data": data, "prior": prior, "interpolated": interpolated, "times": times}
    if cfg.d_rep is not None:
        batch["rep"] = rng.standard_normal((batch_size, cfg.d_rep)).astype(np.float32)
    return batch


def time_grid(steps: int, sampling_strategy: str = "linear"):
    """The integrator's (times [steps], step sizes [steps], t_final) in f32:
    a linear grid on [0, 1] or the log grid 1 - geomspace(0.01, 1) reversed."""
    if sampling_strategy == "linear":
        points = np.linspace(0, 1, steps + 1)
    elif sampling_strategy == "log":
        points = (1 - np.geomspace(0.01, 1.0, steps + 1))[::-1].copy()
    else:
        raise ValueError(sampling_strategy)
    return (points[:-1].astype(np.float32), np.diff(points).astype(np.float32),
            float(np.float32(points[-2])))


@torch.no_grad()
def generate(model: nn.Module, cfg: SemlaTrainConfig, prior: Dict, rep=None,
             generator: Optional[torch.Generator] = None,
             sampling_strategy: str = "linear", final_protocol: str = "last",
             zero_cond: bool = False, pred_temp: float = 1.0, draws=None) -> Dict:
    """Integrate from the prior (a dict of tensors on the model's device:
    coords/atomics/bonds/mask) to data in cfg.integrator.steps Euler steps
    (reference: fm.py:974-1040). Returns the prediction of the last loop
    step with final_protocol 'last' (reference-exact: the model never sees
    the jumped t = 1 state) or of one more model call on the final state at
    the last grid time with 'extra'. zero_cond keeps the self-conditioning
    input at zeros; pred_temp sharpens the type/bond distributions the
    integrator consumes (softmax(logits / T); the returned molecule and the
    self-conditioning input keep T = 1). The integrator draws from
    `generator`, or from `draws[i]` (a list of tensors, see integrator_step)
    at step i. Inside draws.global_rows the prior and rep are this rank's
    rows of the global batch, and the draws are made (or given) at the
    global batch."""
    steps = cfg.integrator.steps
    times_arr, sizes_arr, t_final = time_grid(steps, sampling_strategy)
    b = prior["coords"].shape[0]
    device = prior["coords"].device

    def predict(curr, t, cond):
        coords, tl, bl, cl, _ = _apply(model, cfg, curr, t, cond, rep)
        return {"coords": coords, "atomics": torch.softmax(tl, dim=-1),
                "bonds": torch.softmax(bl, dim=-1), "charges": torch.softmax(cl, dim=-1)}

    curr, cond, predicted = dict(prior), _zero_cond(prior), None
    for i in range(steps):
        t = torch.full((b,), float(times_arr[i]), device=device)
        predicted = predict(curr, t, cond)
        step_pred = predicted
        if pred_temp != 1.0:
            step_pred = dict(predicted)
            for k in ("atomics", "bonds"):
                p = predicted[k] ** (1.0 / pred_temp)
                step_pred[k] = p / (p.sum(-1, keepdim=True) + 1e-12)
        curr = integrator_step(cfg.integrator, curr, step_pred, prior, t,
                               float(sizes_arr[i]), generator=generator,
                               draws=None if draws is None else draws[i])
        if not zero_cond:
            cond = {k: predicted[k] for k in ("coords", "atomics", "bonds")}
    if final_protocol == "last":
        final = dict(predicted)
    elif final_protocol == "extra":
        final = predict(curr, torch.full((b,), t_final, device=device), cond)
    else:
        raise ValueError(f"final_protocol must be last or extra, got {final_protocol!r}")
    final["mask"] = prior["mask"]
    return final


def sample_prior(cfg: SemlaTrainConfig, rng_np: np.random.Generator, mask: np.ndarray,
                 device=None) -> Dict:
    """A prior batch for `mask` [B, N] (numpy draws), on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in sample_prior_batch(
        rng_np, cfg.interpolant.prior, mask).items()}


class SemlaTrainer:
    """reed_tpu's SemlaTrainer: `init_state()`, then `train_step(state,
    batch) -> (state, metrics)` (in place, on a batch from batch_to_device),
    plus `example_batch`, `sample_prior` and `generate`. Weights are
    initialised from a generator seeded cfg.seed (the same on every rank);
    the self-conditioning coin, one for the whole global batch, comes from
    `self.generator`, a CPU generator seeded cfg.seed + 1. Under a process
    group (`self.dp`) a step takes this rank's rows of a global host batch
    built as one process builds it (the OT coupling included;
    parallel.mesh.local_batch) and its metrics are the global batch's; the
    tensor axis splits arch semla's model (build_model), and runs the egnn
    and eqgat archs whole on every tensor rank."""

    def __init__(self, cfg: SemlaTrainConfig, device=None):
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=SEMLA_AXES)
        self.generator = torch.Generator().manual_seed(cfg.seed + 1)
        # REPA at repa_loss_weight with no decay; the warm-up applies to the
        # diffusion losses (fm.py:655-662,860-865)
        self.curriculum = CurriculumConfig(**{
            **cfg.curriculum.__dict__,
            "proj_coeff": cfg.repa_loss_weight,
            "diffusion_warmup_steps": max(cfg.diffusion_loss_max_step,
                                          cfg.curriculum.diffusion_warmup_steps),
        })
        self._train_step = make_train_step(make_loss_fn(cfg), self.curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)
        self._ema_model = None

    def init_state(self) -> TrainState:
        model = build_model(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed), parallel=self.dp)
        # the replicated leaves' gradients (every leaf of the egnn and eqgat
        # archs, which SEMLA_TP_RULES do not name) are averaged over the
        # tensor group, so the tensor ranks' copies stay bitwise equal
        # whatever order the card's reductions (the size table's backward
        # scatter) take
        return init_train_state(model, self.cfg.optim, self.cfg.curriculum.ema_dtype, self.dp,
                                tp_rules=SEMLA_TP_RULES, sync_replicated=True)

    def train_step(self, state: TrainState, batch, use_sc: Optional[bool] = None):
        """One step on a device batch; `use_sc` fixes the self-conditioning
        coin (as in make_loss_fn)."""
        return self._train_step(state, batch, generator=self.generator, use_sc=use_sc)

    def example_batch(self, batch_size: int, max_n: int = 16, seed: int = 0) -> Dict:
        return example_batch(self.cfg, batch_size, max_n, seed)

    def sample_prior(self, rng_np: np.random.Generator, mask: np.ndarray) -> Dict:
        """A prior batch for `mask` [B, N] (numpy draws), on the device."""
        return sample_prior(self.cfg, rng_np, mask, self.device)

    def ema_model(self, state: TrainState) -> nn.Module:
        """A copy of the model (kept for reuse) holding the state's EMA."""
        if self._ema_model is None:
            self._ema_model = whole_copy(state.model, state.opt.plan)
        with torch.no_grad():
            ema = ema_weights(state)
            for name, p in self._ema_model.named_parameters():
                p.copy_(ema[name])
        return self._ema_model

    def generate(self, model: nn.Module, prior: Dict, rep=None,
                 generator: Optional[torch.Generator] = None, **kwargs) -> Dict:
        """`generate` with this trainer's configuration."""
        return generate(model, self.cfg, prior, rep=rep, generator=generator, **kwargs)
