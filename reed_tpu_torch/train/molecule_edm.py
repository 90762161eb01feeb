"""Molecule trainer on the EDM path: E(n) equivariant diffusion (or, with
probabilistic_model 'fm', equivariant flow matching) of QM9 / GEOM point
clouds, conditioned on frozen-encoder representations (GeoRCG/REED
two-stage scheme). Counterpart of reed_tpu/train/molecule_edm.py
(reference: molecule/src/self_condition_train_qm9.py,
molecule/train_test.py:20-168).

One train step removes the centre of mass, optionally rotates, and runs the
EDM L2 loss (or the EFM loss) through EGNNDynamics with the rep dropped to
the learned fake latent at rep_dropout_prob; Adam and the EMA follow
(core/trainer.py). The step's draws (t, eps, the rep-dropout mask, the
rotation quaternions, the dequantisation noise) come from the trainer's
device generator, seeded cfg.seed + 1, or are handed in. Sampling runs the
ancestral EDM loop or the EFM ODE decode from any weights, with
classifier-free guidance where cfg_scale is given and an optional learned
noise schedule (GammaNetwork). The port trains in f32 or, with
compute_dtype bfloat16, in bf16 over f32 parameters as reed_tpu's `dtype`
computes (models/egnn.py), on one device or over torch.distributed's ranks
(data, fsdp and tensor axes; the tensor axis splits the EGNN by
parallel/mesh.EGNN_TP_RULES, and every tensor rank of a batch index draws
the same rows, times, noise, rotations and rep-dropout mask).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_weights
from reed_tpu_torch.core.train_state import TrainState, init_train_state
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.edm import (EDMConfig, EnVariationalDiffusion, gamma_lookup,
                                         make_gamma_table)
from reed_tpu_torch.diffusion.efm import EFMConfig, EquivariantCNF
from reed_tpu_torch.models.egnn import EGNNDynamics, remove_mean_with_mask
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.mesh import (EGNN_AXES, EGNN_TP_RULES, data_parallel,
                                         local_batch, shard_state_dict)


@dataclass(frozen=True)
class MoleculeEDMConfig:
    num_atom_types: int = 5          # QM9: H, C, N, O, F
    include_charges: bool = True
    max_nodes: int = 29              # the largest QM9 molecule
    hidden_nf: int = 256
    n_layers: int = 9
    inv_sublayers: int = 1           # the reference QM9 recipe (qm9_pcdm_config.yaml)
    attention: bool = True
    tanh: bool = True
    coords_range: float = 15.0
    normalization_factor: float = 1.0
    aggregation: str = "sum"
    rep_nf: Optional[int] = 256      # frozen-encoder rep dim (None: unconditional)
    rep_dropout_prob: float = 0.1
    context_node_nf: int = 0         # property conditioning dim
    # 'diffusion' (EnVariationalDiffusion) or 'fm' (equivariant CNF flow
    # matching, reference configs/drug_efm_config.yaml probabilistic_model)
    probabilistic_model: str = "diffusion"
    edm: EDMConfig = EDMConfig()
    efm: EFMConfig = EFMConfig()
    augment_rotation: bool = False
    batch_size: int = 64
    optim: OptimConfig = OptimConfig(lr=1e-4, b2=0.999)
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.0,
                                                    diffusion_warmup_steps=0)
    mesh: MeshConfig = MeshConfig()
    compute_dtype: str = "float32"
    seed: int = 0


def check_config(cfg: MoleculeEDMConfig):
    """Raise on what the port does not run."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.probabilistic_model not in ("diffusion", "fm"):
        raise ValueError(f"probabilistic_model must be diffusion or fm, got "
                         f"{cfg.probabilistic_model!r}")


def build_dynamics(cfg: MoleculeEDMConfig, device=None,
                   generator: Optional[torch.Generator] = None,
                   parallel=None) -> EGNNDynamics:
    """The configured EGNNDynamics on `device`, initialised from `generator`
    as reed_tpu initialises it, split over the tensor axis of `parallel` (a
    parallel.mesh.DataParallel): the whole model is initialised as one
    process does, then a tensor rank keeps its shards (EGNN_TP_RULES)."""
    check_config(cfg)
    kwargs = dict(
        in_node_nf=cfg.num_atom_types + int(cfg.include_charges),
        context_node_nf=cfg.context_node_nf, hidden_nf=cfg.hidden_nf,
        n_layers=cfg.n_layers, inv_sublayers=cfg.inv_sublayers,
        attention=cfg.attention, tanh=cfg.tanh, coords_range=cfg.coords_range,
        normalization_factor=cfg.normalization_factor, aggregation=cfg.aggregation,
        rep_nf=cfg.rep_nf, rep_dropout_prob=cfg.rep_dropout_prob,
        compute_dtype=getattr(torch, cfg.compute_dtype))
    with torch.device(device) if device is not None else torch.device("cpu"):
        model = EGNNDynamics(**kwargs).initialize_weights(generator)
        if parallel is not None and parallel.tensor > 1:
            whole, model = model, EGNNDynamics(**kwargs, parallel=parallel)
            model.load_state_dict(shard_state_dict(whole.state_dict(), parallel,
                                                   EGNN_TP_RULES))
        return model


def edm_config(cfg: MoleculeEDMConfig, cfg_scale: Optional[float] = None) -> EDMConfig:
    return replace(cfg.edm, in_node_nf=cfg.num_atom_types + int(cfg.include_charges),
                   include_charges=cfg.include_charges, cfg_scale=cfg_scale)


def efm_config(cfg: MoleculeEDMConfig) -> EFMConfig:
    return replace(cfg.efm, in_node_nf=cfg.num_atom_types + int(cfg.include_charges),
                   include_charges=cfg.include_charges)


def dynamics_fn(model: EGNNDynamics, generator: Optional[torch.Generator] = None):
    """The dynamics function the EDM / EFM wrappers call, over `model`."""
    def fn(t, z, node_mask, edge_mask, context, rep, train, drop):
        return model(t, z, node_mask, edge_mask, context=context, rep=rep, train=train,
                     drop=drop, generator=generator)
    return fn


def build_edm(cfg: MoleculeEDMConfig, model: EGNNDynamics, cfg_scale=None, gamma=None,
              device=None) -> EnVariationalDiffusion:
    """EnVariationalDiffusion over `model`, with CFG at cfg_scale where
    given and the learned schedule `gamma` (a GammaNetwork) where given."""
    def cfg_fn(t, z, node_mask, edge_mask, context, rep):
        return model.forward_with_cfg(t, z, node_mask, edge_mask, context, rep, cfg_scale)

    return EnVariationalDiffusion(edm_config(cfg, cfg_scale), dynamics_fn(model), cfg_fn,
                                  gamma_fn=gamma, device=device)


def random_rotation(x, generator: Optional[torch.Generator] = None, q=None):
    """Uniformly random rotations of x [B,N,3] from normalised Gaussian
    quaternions q [B,4] (drawn where not given)."""
    b = x.shape[0]
    if q is None:
        q = draws.randn((b, 4), generator=generator, device=x.device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, i, j, k = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (j ** 2 + k ** 2), 2 * (i * j - k * w), 2 * (i * k + j * w),
        2 * (i * j + k * w), 1 - 2 * (i ** 2 + k ** 2), 2 * (j * k - i * w),
        2 * (i * k - j * w), 2 * (j * k + i * w), 1 - 2 * (i ** 2 + j ** 2),
    ], dim=-1).reshape(b, 3, 3)
    return torch.einsum("bij,bnj->bni", rot, x)


def make_loss_fn(cfg: MoleculeEDMConfig, device=None):
    """loss_fn(model, batch, step, generator=None, **draws) -> metrics,
    reed_tpu's EDM-path loss: the EDM L2 surrogate ('diffusion') or the
    flow-matching loss ('fm'), batch mean as denoising_loss. `draws` hand in
    what is otherwise drawn from `generator`: quat (the rotations), and
    t_int, eps, drop (diffusion) or deq_noise, t, eps, drop (fm)."""
    fm = cfg.probabilistic_model == "fm"
    ecfg = edm_config(cfg)
    # the gamma table goes to the device once, not every step
    table = torch.from_numpy(make_gamma_table(ecfg.noise_schedule, ecfg.timesteps,
                                              ecfg.noise_precision)).to(device)

    def gamma(t):
        return gamma_lookup(table, t, ecfg.timesteps)

    def loss_fn(model, batch, step, generator=None, quat=None, **draws):
        del step
        node_mask = batch["node_mask"]
        x = remove_mean_with_mask(batch["positions"], node_mask)
        if cfg.augment_rotation:
            x = random_rotation(x, generator, quat) * node_mask
        fn = dynamics_fn(model, generator)
        wrapper = (EquivariantCNF(efm_config(cfg), fn) if fm
                   else EnVariationalDiffusion(ecfg, fn, gamma_fn=gamma))
        nll, _ = wrapper.loss(x, batch["one_hot"], batch["charges"], node_mask,
                              batch["edge_mask"], context=batch.get("context"),
                              rep=batch.get("rep"), train=True, generator=generator,
                              **draws)
        return {"denoising_loss": nll.mean(),
                "proj_loss": torch.zeros((), device=nll.device)}

    return loss_fn


def batch_to_device(batch: Dict, device) -> Dict:
    """A host batch (numpy arrays or CPU tensors) as f32 tensors on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device, non_blocking=True)
            for k, v in batch.items()}


class MoleculeEDMTrainer:
    """reed_tpu's MoleculeEDMTrainer: `init_state()`, then
    `train_step(state, batch, **draws) -> (state, metrics)` (in place), plus
    `synthetic_batch`, `ema_model` and `sample`. Weights are initialised from
    a generator seeded cfg.seed (the same on every rank); the training
    draws come from `self.generator`, a device generator seeded cfg.seed +
    1. Under a process group (`self.dp`) a step takes this rank's rows of
    the global batch (`synthetic_batch` returns them) and its metrics are
    the global batch's; the tensor axis splits the EGNN (build_dynamics)."""

    def __init__(self, cfg: MoleculeEDMConfig, device=None):
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel(cfg.mesh, cfg.batch_size, axes=EGNN_AXES)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._train_step = make_train_step(make_loss_fn(cfg, self.device), cfg.curriculum,
                                           accum_steps=cfg.optim.accum_steps, dp=self.dp)
        self._ema_model = None

    def init_state(self) -> TrainState:
        model = build_dynamics(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed), parallel=self.dp)
        # under the tensor axis the replicated leaves' gradients are averaged
        # over the tensor group, so the ranks' copies stay bitwise equal
        return init_train_state(model, self.cfg.optim, self.cfg.curriculum.ema_dtype, self.dp,
                                tp_rules=EGNN_TP_RULES, sync_replicated=True)

    def train_step(self, state: TrainState, batch, **draws):
        return self._train_step(state, batch, generator=self.generator, **draws)

    def synthetic_batch(self, generator: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Random molecules of max_nodes // 2 .. max_nodes atoms on the device
        (reed_tpu's synthetic_batch schema): zero-CoM Gaussian positions,
        random types, integer charges 1-8, a rep and a per-molecule
        context where configured; this rank's rows of it under a process
        group."""
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
        charges = torch.randint(1, 9, (bs, n, 1), generator=generator, device=dev).float()
        batch = {"positions": remove_mean_with_mask(x, node_mask),
                 "one_hot": torch.nn.functional.one_hot(types, cfg.num_atom_types).float()
                 * node_mask,
                 "charges": charges * node_mask, "node_mask": node_mask,
                 "edge_mask": edge_mask}
        if cfg.rep_nf is not None:
            batch["rep"] = torch.randn((bs, cfg.rep_nf), generator=generator, device=dev)
        if cfg.context_node_nf > 0:
            prop = torch.randn((bs, 1, cfg.context_node_nf), generator=generator, device=dev)
            batch["context"] = prop.expand(bs, n, cfg.context_node_nf) * node_mask
        return local_batch(self.dp, batch)

    def ema_model(self, state: TrainState) -> EGNNDynamics:
        """A copy of the model (kept for reuse) holding the state's EMA."""
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(state.model)
        with torch.no_grad():
            ema = ema_weights(state)
            for name, p in self._ema_model.named_parameters():
                p.copy_(ema[name])
        return self._ema_model

    @torch.no_grad()
    def sample(self, model: EGNNDynamics, node_mask, edge_mask, rep=None, cfg_scale=None,
               context=None, gamma=None, generator: Optional[torch.Generator] = None):
        """(x, one-hot h_cat, h_int) for the molecules of node_mask [B,N,1]
        from `model`, drawing from `generator`: the ancestral EDM loop (with
        CFG at cfg_scale where given and the learned schedule `gamma` where
        given) or, with 'fm', the ODE decode."""
        b, n = node_mask.shape[:2]
        if self.cfg.probabilistic_model == "fm":
            cnf = EquivariantCNF(efm_config(self.cfg), dynamics_fn(model))
            return cnf.sample(b, n, node_mask, edge_mask, context=context, rep=rep,
                              generator=generator)
        edm = build_edm(self.cfg, model, cfg_scale=cfg_scale, gamma=gamma,
                        device=node_mask.device)
        return edm.sample(b, n, node_mask, edge_mask, context=context, rep=rep,
                          generator=generator)
