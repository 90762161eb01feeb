"""Protein inverse folding (ProteinMPNN-FMIF): configuration, model builder,
trainer, synthetic batches and Euler-unmasking sampling.

Counterpart of reed_tpu/train/protein.py (reference:
protein/fmif/train_fmif.py:74-727). One train step corrupts the tokens,
runs the model with dropout, and takes the smoothed CE plus the triple
alignment loss, weighted by the curriculum; Adam with a global-norm clip
and the EMA follow (core/trainer.py). On the card every message chain runs
forward through the CUDA kernel K2a and backward through K2b
(ops/fused_message.py). The port trains on one device, in f32, and draws
every random number (corruption, dropout, coordinate and target noise) from
a torch.Generator; reed_tpu's `rng_impl` (threefry or rbg) picks a JAX
PRNG on the TPU and is not read here.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import TrainState, make_optimizer
from reed_tpu_torch.core.trainer import make_train_step
from reed_tpu_torch.diffusion.discrete import (MaskingInterpolantConfig,
                                               corrupt_batch, euler_unmask_sampler)
from reed_tpu_torch.diffusion.protein_losses import loss_nll, loss_repr, loss_smoothed
from reed_tpu_torch.models.pmpnn import ProteinMPNNFMIF, create_pmpnn


@dataclass(frozen=True)
class ProteinTrainConfig:
    hidden_dim: int = 128
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    k_neighbors: int = 30
    dropout: float = 0.1
    augment_eps: float = 0.0
    update_edge: bool = True
    learnable_node: bool = True
    align_depth: int = 1
    single_dim: int = 384
    pair_dim: int = 128
    structure_dim: int = 768
    mdlm_parameterization: bool = False
    # losses
    smoothing_weight: float = 0.1
    t_schedule: bool = False
    repa_coeff: Sequence[float] = (0.5, 2.0, 1.0)  # single, pair, structure
    repr_weight: float = 0.2
    repr_norm: bool = True
    repr_noise: float = 0.0
    mask_repr_loss: bool = False
    load_repr: bool = True
    interpolant: MaskingInterpolantConfig = field(
        default_factory=MaskingInterpolantConfig)
    batch_size: int = 8
    max_len: int = 256
    optim: OptimConfig = OptimConfig(lr=1e-3, grad_clip=1.0)
    curriculum: CurriculumConfig = CurriculumConfig(proj_coeff=0.2)
    mesh: MeshConfig = MeshConfig()
    compute_dtype: str = "float32"
    # reed_tpu's JAX PRNG choice on the TPU; the port always uses torch.Generator
    rng_impl: str = "threefry"
    # message chains through the CUDA kernel K2a (ops/fused_message.py):
    # "auto" and "on" route through it, "off" runs the unfused layer math
    fused_messages: str = "auto"
    seed: int = 0


def resolve_fused(mode: str) -> bool:
    """'auto' resolves to the fused chain: on the card it runs the
    hand-written kernel. (reed_tpu's 'auto' resolves to off from a TPU
    measurement that says nothing about this card.)"""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_messages must be auto, on or off, got {mode!r}")
    return mode != "off"


def build_model(cfg: ProteinTrainConfig, device=None,
                generator: Optional[torch.Generator] = None) -> ProteinMPNNFMIF:
    """The configured model on `device`, initialised from `generator`, in
    cfg.compute_dtype. Dropout and coordinate noise (cfg.dropout,
    cfg.augment_eps) apply only in a call with train=True."""
    model = create_pmpnn(
        device=device, generator=generator,
        fused=resolve_fused(cfg.fused_messages),
        dropout=cfg.dropout, augment_eps=cfg.augment_eps,
        learnable_node=cfg.learnable_node,
        hidden_dim=cfg.hidden_dim, edge_features=cfg.hidden_dim,
        num_encoder_layers=cfg.num_encoder_layers,
        num_decoder_layers=cfg.num_decoder_layers,
        k_neighbors=cfg.k_neighbors, update_edge=cfg.update_edge,
        align_depth=cfg.align_depth, single_dim=cfg.single_dim,
        pair_dim=cfg.pair_dim, structure_dim=cfg.structure_dim,
        mdlm_parameterization=cfg.mdlm_parameterization)
    return model.to_compute_dtype(getattr(torch, cfg.compute_dtype)).eval()


def synthetic_protein_batch(generator: torch.Generator, batch_size: int,
                            length: int, cfg: Optional[ProteinTrainConfig] = None):
    """A random batch of the featurize() schema on the generator's device:
    backbone coordinates along a loose helix-like random walk (distances in
    the RBF range), tokens, masks, residue indices; with `cfg`, also N(0, 1)
    AF3-style embeddings of its single, pair and structure widths, which
    only training reads."""
    device = generator.device
    steps = torch.randn((batch_size, length, 3), generator=generator,
                        device=device) * 1.5
    axis = torch.tensor([1.0, 0.0, 0.0], device=device)
    ca = torch.cumsum(steps, dim=1) + 3.8 * torch.arange(
        length, device=device)[None, :, None] * axis
    offsets = torch.tensor([[-1.46, 0.0, 0.0], [0.0, 0.0, 0.0],
                            [1.52, 0.0, 0.0], [2.4, 1.0, 0.0]], device=device)
    ones = torch.ones((batch_size, length), device=device)
    batch = {
        "X": ca[:, :, None, :] + offsets[None, None],
        "S": torch.randint(0, 20, (batch_size, length), generator=generator,
                           device=device, dtype=torch.int32),
        "mask": ones,
        "chain_M": ones.clone(),
        "residue_idx": torch.arange(length, device=device, dtype=torch.int32
                                    ).expand(batch_size, -1).contiguous(),
        "chain_encoding_all": torch.zeros((batch_size, length), device=device,
                                          dtype=torch.int32),
    }
    if cfg is not None:
        for key, shape in (("repr_single", (length, cfg.single_dim)),
                           ("repr_pair", (length, length, cfg.pair_dim)),
                           ("repr_structure", (length, cfg.structure_dim))):
            batch[key] = torch.randn((batch_size,) + shape, generator=generator,
                                     device=device)
    return batch


def _model_args(batch):
    return (batch["X"], batch["mask"], batch["chain_M"], batch["residue_idx"],
            batch["chain_encoding_all"])


@torch.no_grad()
def sample(model: ProteinMPNNFMIF, batch, generator: Optional[torch.Generator],
           interpolant: MaskingInterpolantConfig = MaskingInterpolantConfig(),
           cls: Optional[int] = None, w: Optional[float] = None,
           uniforms: Optional[torch.Tensor] = None):
    """Euler unmasking conditioned on the batch's backbones; returns
    (pred_tokens, final_tokens) int32 [B, L]. Without a class the encoder
    depends only on the backbone, so it runs once and every step runs the
    decoder alone; with CFG over a fold class the encoder is
    class-conditioned and runs on every call."""
    x, mask, chain_m, residue_idx, chain_enc = _model_args(batch)
    if cls is None:
        enc = model(x, batch["S"], mask, chain_m, residue_idx, chain_enc,
                    return_enc=True)

        def logits_fn(tokens, cls_arr):
            return model(x, tokens, mask, chain_m, residue_idx, chain_enc,
                         enc_state=enc)
    else:
        def logits_fn(tokens, cls_arr):
            return model(x, tokens, mask, chain_m, residue_idx, chain_enc,
                         cls=cls_arr)

    return euler_unmask_sampler(logits_fn, tuple(batch["S"].shape), interpolant,
                                generator=generator, cls=cls, w=w,
                                num_cls=model.num_cls, device=x.device,
                                uniforms=uniforms)


def make_loss_fn(cfg: ProteinTrainConfig):
    """loss_fn(model, batch, step, generator=None, noisy=None,
    repr_noise=None) -> metrics, reed_tpu's protein loss. The corruption,
    dropout, coordinate noise and target noise draw from `generator`;
    `noisy` = (S_t [B,L], t [B] or [B,1]) replaces the corruption and
    `repr_noise` (three tensors) the target noise, so that a test can hand
    over reed_tpu's draws."""
    detach_repr = cfg.repr_weight <= 0.0

    def loss_fn(model, batch, step, generator=None, noisy=None, repr_noise=None):
        del step
        mask_for_loss = batch["mask"] * batch["chain_M"]
        if noisy is None:
            corrupted = corrupt_batch(batch, cfg.interpolant, generator)
            s_t, t, is_masked = corrupted["S_t"], corrupted["t"], corrupted["is_masked"]
        else:
            s_t = torch.as_tensor(noisy[0], device=mask_for_loss.device).to(torch.int32)
            t = torch.as_tensor(noisy[1], device=mask_for_loss.device).float().reshape(-1, 1)
            is_masked = (s_t == cfg.interpolant.mask_index).float() * mask_for_loss
        log_probs, zs_single, zs_pair, zs_structure, e_idx = model(
            batch["X"], s_t, batch["mask"], batch["chain_M"], batch["residue_idx"],
            batch["chain_encoding_all"], return_rep=True, train=True,
            detach_repr=detach_repr, generator=generator)
        _, ce = loss_smoothed(batch["S"], log_probs, mask_for_loss,
                              cfg.smoothing_weight, t=t, t_schedule=cfg.t_schedule)
        metrics = {"denoising_loss": ce}
        if cfg.load_repr:
            l_s, l_p, l_st, l_sm, l_pm, l_stm = loss_repr(
                batch["repr_single"], batch["repr_pair"], batch["repr_structure"],
                zs_single, zs_pair, zs_structure, e_idx, mask_for_loss, is_masked,
                generator=generator, repr_norm=cfg.repr_norm,
                repr_noise=cfg.repr_noise, noise=repr_noise)
            c = cfg.repa_coeff
            align = (l_sm * c[0] + l_pm * c[1] + l_stm * c[2] if cfg.mask_repr_loss
                     else l_s * c[0] + l_p * c[1] + l_st * c[2])
            metrics.update(proj_loss=align, loss_single=l_s, loss_pair=l_p,
                           loss_structure=l_st)
        _, nll_av, true_false = loss_nll(batch["S"], log_probs, mask_for_loss)
        metrics.update(nll=nll_av, accuracy=torch.sum(true_false * mask_for_loss)
                       / torch.sum(mask_for_loss))
        return metrics

    return loss_fn


class ProteinTrainer:
    """reed_tpu's ProteinTrainer on one device: `init_state()`, then
    `train_step(state, batch) -> (state, metrics)` (in place), plus
    `synthetic_batch` and `sample`. Weights are initialised from a generator
    seeded cfg.seed; the training draws come from `self.generator`, seeded
    cfg.seed + 1."""

    def __init__(self, cfg: ProteinTrainConfig, device=None):
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r} training is not ported: the "
                "port trains in f32 (bf16 training needs f32 master weights cast "
                "at use, as flax does)")
        cfg.mesh.check_single_device()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        # projector-only mode trains at unit weight (train_fmif.py:305)
        curriculum = CurriculumConfig(**{
            **cfg.curriculum.__dict__,
            "proj_coeff": 1.0 if cfg.repr_weight <= 0.0 else cfg.repr_weight})
        self.curriculum = curriculum
        self._train_step = make_train_step(make_loss_fn(cfg), curriculum,
                                           accum_steps=cfg.optim.accum_steps)
        self._ema_model = None

    def init_state(self) -> TrainState:
        model = build_model(self.cfg, device=self.device, generator=torch.Generator(
            device=self.device).manual_seed(self.cfg.seed))
        return TrainState(step=0, model=model,
                          ema=ema_init(model, self.cfg.curriculum.ema_dtype),
                          opt=make_optimizer(self.cfg.optim, list(model.parameters())))

    def train_step(self, state: TrainState, batch, noisy=None, repr_noise=None):
        """One step on a batch of tensors on the trainer's device; `noisy`
        and `repr_noise` as in make_loss_fn."""
        return self._train_step(state, batch, generator=self.generator,
                                noisy=noisy, repr_noise=repr_noise)

    def synthetic_batch(self, generator: Optional[torch.Generator] = None,
                        batch_size: Optional[int] = None, length: Optional[int] = None):
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        return synthetic_protein_batch(generator, batch_size or cfg.batch_size,
                                       length or cfg.max_len, cfg)

    def sample(self, state: TrainState, batch, generator: Optional[torch.Generator],
               ema: bool = False, cls: Optional[int] = None, w: Optional[float] = None):
        """Euler unmasking with the state's parameters, or with its EMA
        (loaded into a copy of the model kept for this)."""
        model = state.model
        if ema:
            if self._ema_model is None:
                self._ema_model = copy.deepcopy(state.model)
            model = self._ema_model
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(state.ema[name])
        return sample(model, batch, generator, self.cfg.interpolant, cls=cls, w=w)
