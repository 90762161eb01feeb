"""Property-classifier trainer: the EGNN regressor for QM9 scalar
properties, and the linear probe on frozen-encoder reps. Counterpart of
reed_tpu/train/property.py (reference:
molecule/qm9/property_prediction/main_qm9_prop.py): one-hot node features,
the L1 loss on the mad-normalised property (main_qm9_prop.py:88
`loss_l1(pred, (label - mean) / mad)`), Adam with a cosine-annealed
learning rate (:229-231), on one device in f32. The trained classifier
scores conditional generation (eval_src/eval_conditional_qm9.py).

The loss draws nothing; the weights are initialised from a generator
seeded cfg.seed, and `self.generator` (seeded cfg.seed + 1) is kept for
the checkpoint's state, as the other trainers keep theirs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_weights
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.models.property_classifier import PropertyClassifier
from reed_tpu_torch.parallel.mesh import (EGNN_AXES, EGNN_TP_RULES, data_parallel,
                                         local_batch, shard_state_dict, whole_copy)

QM9_PROPERTIES = ("alpha", "gap", "homo", "lumo", "mu", "Cv", "G", "H",
                  "r2", "U", "U0", "zpve")
BATCH_KEYS = ("one_hot", "positions", "node_mask", "edge_mask", "label", "rep")


def compute_mean_mad(values: np.ndarray) -> Tuple[float, float]:
    """Mean and mean absolute deviation of a property column (reference:
    qm9/utils.py compute_mean_mad_from_dataloader)."""
    values = np.asarray(values, np.float64)
    mean = float(values.mean())
    mad = float(np.abs(values - mean).mean())
    return mean, max(mad, 1e-12)


@dataclass(frozen=True)
class PropertyTrainConfig:
    property: str = "alpha"
    num_atom_types: int = 5
    max_nodes: int = 29
    hidden_nf: int = 128                 # reference --nf 128
    n_layers: int = 7                    # reference --n_layers 7
    attention: bool = True
    mean: float = 0.0                    # property normaliser (train split)
    mad: float = 1.0
    batch_size: int = 96                 # reference --batch_size 96
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0)
    optim: OptimConfig = OptimConfig(lr=1e-3, weight_decay=1e-16, schedule="cosine",
                                     warmup_steps=0, total_steps=100_000)
    mesh: MeshConfig = MeshConfig()
    seed: int = 1


def build_model(cfg: PropertyTrainConfig, device=None,
                generator: Optional[torch.Generator] = None,
                parallel=None) -> PropertyClassifier:
    """The configured PropertyClassifier on `device`, initialised from
    `generator` as reed_tpu initialises it, split over the tensor axis of
    `parallel` (a parallel.mesh.DataParallel): the whole model is
    initialised as one process does, then a tensor rank keeps its shards
    (EGNN_TP_RULES)."""
    kwargs = dict(hidden_nf=cfg.hidden_nf, n_layers=cfg.n_layers, attention=cfg.attention)
    with torch.device(device) if device is not None else torch.device("cpu"):
        model = PropertyClassifier(cfg.num_atom_types, **kwargs).initialize_weights(generator)
        if parallel is not None and parallel.tensor > 1:
            whole = model
            model = PropertyClassifier(cfg.num_atom_types, **kwargs, parallel=parallel)
            model.load_state_dict(shard_state_dict(whole.state_dict(), parallel,
                                                   EGNN_TP_RULES))
        return model


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors) as f32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device)
            for k, v in batch.items() if k in BATCH_KEYS}


def _l1_loss(pred, label, mean: float, mad: float):
    target = (label - mean) / mad
    loss = torch.abs(pred - target).mean()
    return {"denoising_loss": loss, "proj_loss": torch.zeros((), device=loss.device)}


def make_loss_fn(cfg: "PropertyTrainConfig"):
    """loss_fn(model, batch, step) -> metrics: the L1 loss of the
    classifier's prediction against the mad-normalised label (reference
    main_qm9_prop.py:88), as denoising_loss."""
    def loss_fn(model, batch, step):
        del step
        pred = model(batch["one_hot"], batch["positions"], batch["node_mask"],
                     batch["edge_mask"])
        return _l1_loss(pred, batch["label"], cfg.mean, cfg.mad)

    return loss_fn


def make_probe_loss_fn(cfg: "LinearProbeConfig"):
    """loss_fn(model, batch, step) -> metrics: the linear probe's L1 loss on
    batch['rep'] against the mad-normalised label."""
    def loss_fn(model, batch, step):
        del step
        return _l1_loss(model(batch["rep"])[..., 0], batch["label"], cfg.mean, cfg.mad)

    return loss_fn


class _Trainer:
    """What both trainers share: the train step over a loss_fn, the state
    and the EMA model. Under a process group (`self.dp`) a step takes this
    rank's rows of the global batch (`synthetic_batch` returns them) and its
    metrics are the global batch's. Both run the tensor axis (EGNN_AXES):
    the classifier split by `tp_rules`, the linear probe, which no rule
    names (nothing in Linear(rep_dim, 1) to split), whole on every tensor
    rank, as reed_tpu runs it."""

    tp_rules: tuple = ()

    def __init__(self, cfg, loss_fn, curriculum: CurriculumConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=EGNN_AXES)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.curriculum = replace(curriculum, max_steps=cfg.optim.total_steps)
        self._train_step = make_train_step(loss_fn, self.curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)

    def _build(self, generator=None) -> nn.Module:
        raise NotImplementedError

    def init_state(self) -> TrainState:
        model = self._build(torch.Generator(device=self.device).manual_seed(self.cfg.seed))
        # under the tensor axis the replicated leaves' gradients (every leaf
        # of the linear probe) are averaged over the tensor group, so the
        # ranks' copies stay bitwise equal
        return init_train_state(model, self.cfg.optim, self.curriculum.ema_dtype, self.dp,
                                tp_rules=self.tp_rules, sync_replicated=True)

    def train_step(self, state: TrainState, batch):
        return self._train_step(state, batch)

    def ema_model(self, state: TrainState) -> nn.Module:
        """A copy of the model holding the state's EMA, in eval mode."""
        model = whole_copy(state.model, state.opt.plan)
        with torch.no_grad():
            ema = ema_weights(state)
            for name, p in model.named_parameters():
                p.copy_(ema[name])
        return model.eval()

    def _denormalize(self, pred, denormalize: bool):
        return pred * self.cfg.mad + self.cfg.mean if denormalize else pred


class PropertyTrainer(_Trainer):
    """reed_tpu's PropertyTrainer: `init_state()`, then
    `train_step(state, batch) -> (state, metrics)` (in place), plus
    `synthetic_batch`, `ema_model` and `predict`; the tensor axis splits
    the classifier's layers (build_model)."""

    tp_rules = EGNN_TP_RULES

    def __init__(self, cfg: PropertyTrainConfig, device=None):
        super().__init__(cfg, make_loss_fn(cfg), cfg.curriculum, device)

    def _build(self, generator=None) -> PropertyClassifier:
        return build_model(self.cfg, device=self.device, generator=generator, parallel=self.dp)

    def synthetic_batch(self, generator: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """reed_tpu's synthetic batch on the device: molecules of max_nodes
        // 2 .. max_nodes atoms, Gaussian positions, random types, and a
        label correlated with the composition so the loss can move."""
        cfg = self.cfg
        bs = batch_size or cfg.batch_size
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        n, dev = cfg.max_nodes, self.device
        sizes = torch.randint(max(2, n // 2), n + 1, (bs,), generator=generator, device=dev)
        node_mask = (torch.arange(n, device=dev)[None, :] < sizes[:, None]).float()[..., None]
        diag = torch.eye(n, device=dev)[None, :, :, None]
        edge_mask = node_mask[:, :, None, :] * node_mask[:, None, :, :] * (1.0 - diag)
        x = torch.randn((bs, n, 3), generator=generator, device=dev) * node_mask
        types = torch.randint(0, cfg.num_atom_types, (bs, n), generator=generator, device=dev)
        one_hot = torch.nn.functional.one_hot(types, cfg.num_atom_types).float() * node_mask
        label = (one_hot.sum(dim=(1, 2)) * 0.1
                 + torch.randn((bs,), generator=generator, device=dev) * 0.01)
        return local_batch(self.dp, {"one_hot": one_hot, "positions": x,
                                     "node_mask": node_mask, "edge_mask": edge_mask,
                                     "label": label})

    @torch.no_grad()
    def predict(self, model: PropertyClassifier, one_hot, positions, node_mask, edge_mask,
                denormalize: bool = True):
        """The property prediction [B] from `model`; with denormalize=True in
        label units (reference eval: mad * pred + mean,
        main_qm9_prop.py:92-94). Inputs may be numpy or tensors anywhere;
        they move to the trainer's device."""
        return predict(self.cfg, model, one_hot, positions, node_mask, edge_mask,
                       denormalize=denormalize, device=self.device)


@torch.no_grad()
def predict(cfg: PropertyTrainConfig, model: PropertyClassifier, one_hot, positions, node_mask,
            edge_mask, denormalize: bool = True, device=None):
    """The property prediction [B] from `model` (split over its tensor ranks
    where it was built so); with denormalize=True in label units (mad *
    pred + mean, reference eval main_qm9_prop.py:92-94). Inputs may be numpy
    or tensors anywhere; they move to `device` (default: the model's)."""
    if device is None:
        device = next(model.parameters()).device
    args = [torch.as_tensor(a, dtype=torch.float32).to(device)
            for a in (one_hot, positions, node_mask, edge_mask)]
    pred = model(*args)
    return pred * cfg.mad + cfg.mean if denormalize else pred


@dataclass(frozen=True)
class LinearProbeConfig:
    """Frozen-encoder linear probe for property prediction (reference:
    qm9/property_prediction/main_qm9_prop_pretrainedEnc_linear.py:132-171,
    Encoder_Linear: a frozen Frad encoder and Linear(rep_dim, 1), L1 on the
    mad-normalised label). The encoder's forward is the precomputed reps.npy,
    so the probe trains on rep vectors."""

    property: str = "alpha"
    rep_dim: int = 256
    mean: float = 0.0
    mad: float = 1.0
    batch_size: int = 96
    optim: OptimConfig = OptimConfig(lr=1e-3, weight_decay=1e-16, schedule="cosine",
                                     warmup_steps=0, total_steps=100_000)
    mesh: MeshConfig = MeshConfig()
    seed: int = 1


class LinearProbeTrainer(_Trainer):
    """reed_tpu's LinearProbeTrainer: nn.Linear(rep_dim, 1)
    (flax's Dense(1) init: lecun-normal weight, zero bias), whole on every
    tensor rank."""

    def __init__(self, cfg: LinearProbeConfig, device=None):
        super().__init__(cfg, make_probe_loss_fn(cfg),
                         CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0), device)

    def _build(self, generator=None) -> nn.Linear:
        model = nn.Linear(self.cfg.rep_dim, 1, device=self.device)
        std = self.cfg.rep_dim ** -0.5 / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(model.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(model.bias)
        return model

    def synthetic_batch(self, generator: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """reed_tpu's synthetic batch: N(0, 1) reps and labels linear in them."""
        bs = batch_size or self.cfg.batch_size
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        rep = torch.randn((bs, self.cfg.rep_dim), generator=generator, device=self.device)
        w = torch.randn((self.cfg.rep_dim,), generator=generator,
                        device=self.device) / np.sqrt(self.cfg.rep_dim)
        return local_batch(self.dp, {"rep": rep, "label": rep @ w})

    @torch.no_grad()
    def predict(self, model: nn.Linear, rep, denormalize: bool = True):
        rep = torch.as_tensor(rep, dtype=torch.float32).to(self.device)
        return self._denormalize(model(rep)[..., 0], denormalize)


def property_epoch_batches(data: Dict[str, np.ndarray], prop: str, batch_size: int,
                           rng: np.random.Generator, max_nodes: int = 29,
                           num_atom_types: int = 5) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epochs of PropertyTrainer-schema batches (host numpy) from
    the EDM QM9 npz layout, carrying the property column as the label."""
    from reed_tpu_torch.data.molecule import edm_epoch_batches

    labels = np.asarray(data[prop], np.float32)
    m = len(np.asarray(data["positions"]))
    order = rng.permutation(m)
    for i in range(0, m - batch_size + 1, batch_size):
        idx = order[i:i + batch_size]
        sub = {k: np.asarray(v)[idx] for k, v in data.items()
               if k in ("positions", "charges", "one_hot", "num_atoms")}
        batch = next(edm_epoch_batches(sub, batch_size, np.random.default_rng(0),
                                       shuffle=False, max_nodes=max_nodes,
                                       num_atom_types=num_atom_types))
        del batch["charges"]
        batch["label"] = labels[idx]
        yield batch
