"""SE(3) flow-matching interpolant: joint translation / rotation / sequence
corruption and Euler sampling for protein backbone codesign (MultiFlow).
Counterpart of reed_tpu/diffusion/se3.py (reference:
protein/multiflow/data/interpolant.py:49-616).

  - translations: a centred Gaussian prior (nm scale), optionally coupled
    to the batch by minibatch OT with Kabsch alignment (host numpy and
    scipy's Hungarian step, in the input pipeline), linear path
  - rotations: IGSO3(1.5) noise multiplied on the right, geodesic path with
    a linear or exp schedule; Euler step Exp_{R_t}(scale dt Log_{R_t}(R1))
  - aatypes: masking or uniform discrete flow matching; Euler steps with
    noise terms and optional purity-ordered unmasking

Convention: t = 1 is clean data, t = 0 noise. Every draw is held in a
dataclass (`CorruptDraws`, `SE3SampleDraws`) that can be handed in; where
it is not, it is drawn from `generator` on the batch's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch.ops.so3 import geodesic_t, igso3_draws, sample_igso3
from reed_tpu_torch.parallel import draws

MASK_TOKEN_INDEX = 20
NUM_TOKENS = 21
NM_TO_ANG = 10.0


@dataclass(frozen=True)
class SE3InterpolantConfig:
    min_t: float = 1e-2
    num_timesteps: int = 100
    # trans
    trans_batch_ot: bool = True
    trans_scale: float = NM_TO_ANG       # prior is N(0, I) in nm -> Angstrom
    # rots
    rots_train_schedule: str = "linear"   # linear | exp
    rots_sample_schedule: str = "exp"     # linear | exp
    rots_exp_rate: float = 10.0
    igso3_sigma: float = 1.5
    # aatypes
    aatypes_interpolant: str = "masking"  # masking | uniform
    aatypes_temp: float = 0.1
    aatypes_noise: float = 20.0
    aatypes_do_purity: bool = True


def time_grid(min_t: float, steps: int, device=None):
    """linspace(min_t, 1, steps) in f32, computed as jnp.linspace computes
    it: start (1 - i / (steps - 1)) + stop i / (steps - 1), the end exact."""
    if steps < 2:
        return torch.full((steps,), min_t, dtype=torch.float32, device=device)
    step = torch.arange(steps - 1, dtype=torch.float32, device=device) / (steps - 1)
    start = torch.tensor(min_t, dtype=torch.float32, device=device)
    out = start * (1 - step) + torch.tensor(1.0, device=device) * step
    return torch.cat([out, torch.ones(1, device=device)])


def centered_gaussian(noise, mask):
    """The normal draws noise [B,N,3] masked and centred on the masked
    mean."""
    x = noise * mask[..., None]
    n = torch.clamp(mask.sum(-1, keepdim=True)[..., None], min=1.0)
    com = (x * mask[..., None]).sum(-2, keepdim=True) / n
    return (x - com) * mask[..., None]


@dataclass
class CorruptDraws:
    """The draws of one corrupt_batch: t_u [B,1] uniform (t = min_t + (1 -
    2 min_t) t_u), trans_noise [B,N,3] normal (None where the batch carries
    its coupled prior trans_0), rot_u [B,N] and rot_axis [B,N,3] (IGSO3),
    aatypes_u [B,N] uniform and, for the uniform interpolant,
    aatypes_uniform [B,N] tokens in [0, 20)."""
    t_u: torch.Tensor
    trans_noise: Optional[torch.Tensor]
    rot_u: torch.Tensor
    rot_axis: torch.Tensor
    aatypes_u: torch.Tensor
    aatypes_uniform: Optional[torch.Tensor] = None

    @staticmethod
    def draw(cfg: SE3InterpolantConfig, b: int, n: int, with_trans_noise: bool = True,
             generator: Optional[torch.Generator] = None, device=None) -> "CorruptDraws":
        t_u = draws.rand((b, 1), generator=generator, device=device)
        trans_noise = (draws.randn((b, n, 3), generator=generator, device=device)
                       if with_trans_noise else None)
        rot_u, rot_axis = igso3_draws((b, n), generator, device)
        aatypes_u = draws.rand((b, n), generator=generator, device=device)
        uniform = (draws.randint(0, 20, (b, n), generator=generator, device=device)
                   if cfg.aatypes_interpolant == "uniform" else None)
        return CorruptDraws(t_u, trans_noise, rot_u, rot_axis, aatypes_u, uniform)


def corrupt_trans(cfg: SE3InterpolantConfig, trans_1, t, res_mask, trans_0=None, noise=None):
    """Linear path from the centred Gaussian prior (or from the batch's
    coupled prior trans_0); trans in Angstrom, t [B, 1]."""
    if trans_0 is None:
        trans_0 = centered_gaussian(noise, res_mask) * cfg.trans_scale
    trans_t = (1 - t[..., None]) * trans_0 + t[..., None] * trans_1
    return trans_t * res_mask[..., None]


def _masked_kabsch_align(x, y, w):
    """Rigidly align x onto y (both [..., N, 3], weights w [..., N]) by
    weighted Kabsch; returns x aligned (numpy, on the host)."""
    w = w[..., None]
    wsum = np.maximum(w.sum(-2, keepdims=True), 1e-8)
    xc = (x * w).sum(-2, keepdims=True) / wsum
    yc = (y * w).sum(-2, keepdims=True) / wsum
    x0, y0 = (x - xc) * w, (y - yc) * w
    h = np.einsum("...ni,...nj->...ij", x0, y0)
    u, _, vt = np.linalg.svd(h)
    det = np.linalg.det(np.einsum("...ij,...jk->...ik", u, vt))
    d = np.ones(h.shape[:-2] + (3,))
    d[..., -1] = det
    rot = np.einsum("...ij,...j,...jk->...ik", u, d, vt)
    return np.einsum("...ni,...ij->...nj", x - xc, rot) + yc


def batch_ot_trans_prior(rng_np: np.random.Generator, trans_1, res_mask,
                         trans_scale: float) -> np.ndarray:
    """The batch-OT coupled translation prior (reference:
    interpolant.py:88-107 _batch_ot): B centred Gaussians, every (noise,
    structure) pair Kabsch-aligned, the masked mean-distance cost matrix,
    a Hungarian assignment, and the aligned noise matched to each
    structure. Host numpy, in the input pipeline."""
    from scipy.optimize import linear_sum_assignment

    trans_1 = np.asarray(trans_1, np.float64)
    res_mask = np.asarray(res_mask, np.float64)
    b, n = res_mask.shape
    noise = rng_np.standard_normal((b, n, 3)) * res_mask[..., None]
    com = noise.sum(-2, keepdims=True) / np.maximum(res_mask.sum(-1)[:, None, None], 1.0)
    noise = (noise - com) * res_mask[..., None] * trans_scale

    # all pairs: noise i aligned onto structure j
    x = np.broadcast_to(noise[:, None], (b, b, n, 3))
    y = np.broadcast_to(trans_1[None, :], (b, b, n, 3))
    w = np.broadcast_to(res_mask[None, :], (b, b, n))
    aligned = _masked_kabsch_align(x, y, w)
    cost = (np.linalg.norm((aligned - y) * w[..., None], axis=-1).sum(-1)
            / np.maximum(w.sum(-1), 1.0))
    noise_idx, gt_idx = linear_sum_assignment(cost)
    out = np.empty_like(noise)
    out[gt_idx] = aligned[noise_idx, gt_idx]
    return out.astype(np.float32)


def corrupt_rotmats(cfg: SE3InterpolantConfig, rotmats_1, t, res_mask, u, axis):
    """The geodesic from IGSO3-noised rotations; identity where masked."""
    noise = sample_igso3(cfg.igso3_sigma, res_mask.shape, u=u, axis=axis)
    rotmats_0 = rotmats_1 @ noise
    so3_t = 1 - torch.exp(-t * cfg.rots_exp_rate) if cfg.rots_train_schedule == "exp" else t
    rotmats_t = geodesic_t(so3_t[..., None], rotmats_1, rotmats_0)
    eye = torch.eye(3, dtype=rotmats_t.dtype, device=rotmats_t.device)
    m = res_mask[..., None, None]
    return rotmats_t * m + eye * (1 - m)


def corrupt_aatypes(cfg: SE3InterpolantConfig, aatypes_1, t, res_mask, u, uniform=None):
    """Masking or uniform corruption: each token is replaced with
    probability 1 - t; padding is the mask token."""
    corrupt = u < (1 - t)
    if cfg.aatypes_interpolant == "masking":
        aatypes_t = torch.where(corrupt, MASK_TOKEN_INDEX, aatypes_1)
    elif cfg.aatypes_interpolant == "uniform":
        aatypes_t = torch.where(corrupt, uniform, aatypes_1)
    else:
        raise ValueError(cfg.aatypes_interpolant)
    return torch.where(res_mask.bool(), aatypes_t, MASK_TOKEN_INDEX).long()


def corrupt_batch(cfg: SE3InterpolantConfig, batch: Dict,
                  draws: Optional[CorruptDraws] = None,
                  generator: Optional[torch.Generator] = None) -> Dict:
    """batch: trans_1 [B,N,3] (Angstrom), rotmats_1 [B,N,3,3], aatypes_1
    [B,N], res_mask [B,N] (and trans_0 where the pipeline coupled the
    prior). Adds the *_t fields and the per-modality times (one t a row)."""
    b, n = batch["res_mask"].shape
    if draws is None:
        draws = CorruptDraws.draw(cfg, b, n, with_trans_noise="trans_0" not in batch,
                                  generator=generator, device=batch["res_mask"].device)
    t = draws.t_u * (1 - 2 * cfg.min_t) + cfg.min_t
    out = dict(batch)
    out["so3_t"] = out["r3_t"] = out["cat_t"] = t
    out["trans_t"] = corrupt_trans(cfg, batch["trans_1"], t, batch["res_mask"],
                                   trans_0=batch.get("trans_0"), noise=draws.trans_noise)
    out["rotmats_t"] = corrupt_rotmats(cfg, batch["rotmats_1"], t, batch["res_mask"],
                                       draws.rot_u, draws.rot_axis)
    out["aatypes_t"] = corrupt_aatypes(cfg, batch["aatypes_1"], t, batch["res_mask"],
                                       draws.aatypes_u, draws.aatypes_uniform)
    return out


# -- sampling ------------------------------------------------------------------

def _trans_euler_step(d_t, t, trans_1_pred, trans_t):
    vf = (trans_1_pred - trans_t) / (1 - t)
    return trans_t + vf * d_t


def _rots_euler_step(cfg, d_t, t, rotmats_1_pred, rotmats_t):
    scaling = 1.0 / (1.0 - t) if cfg.rots_sample_schedule == "linear" else cfg.rots_exp_rate
    return geodesic_t(scaling * d_t, rotmats_1_pred, rotmats_t)


def _regularize_step_probs(step_probs, aatypes_t):
    """Clamp, and put the remaining mass on the current token (reference:
    interpolant.py:285-303)."""
    s = step_probs.shape[-1]
    step_probs = torch.clamp(step_probs, 0.0, 1.0)
    onehot = F.one_hot(aatypes_t, s).to(step_probs.dtype)
    step_probs = step_probs * (1 - onehot)
    resid = torch.clamp(1.0 - step_probs.sum(-1, keepdim=True), 0.0, 1.0)
    return step_probs + resid * onehot


def _gumbel_argmax(probs, u):
    """argmax(probs / e), e = 1e-10 - log(u + 1e-10): a categorical sample
    from the uniform draws u."""
    e = 1e-10 - torch.log(u + 1e-10)
    return torch.argmax(probs / e, dim=-1)


def _aatypes_euler_step(cfg, d_t, t, logits_1, aatypes_t, gumbel_u):
    """Masking / uniform DFM Euler step (reference: interpolant.py:305-345)."""
    s = logits_1.shape[-1]
    if cfg.aatypes_interpolant == "masking":
        logits_1 = logits_1.clone()
        logits_1[..., MASK_TOKEN_INDEX] = -1e9
        probs = torch.softmax(logits_1 / cfg.aatypes_temp, -1)
        is_mask = (aatypes_t == MASK_TOKEN_INDEX)[..., None].float()
        step_probs = d_t * probs * (1 + cfg.aatypes_noise * t) / (1 - t)
        mask_onehot = F.one_hot(torch.tensor(MASK_TOKEN_INDEX), s).to(probs)
        step_probs = step_probs + d_t * (1 - is_mask) * mask_onehot * cfg.aatypes_noise
    else:
        probs = torch.softmax(logits_1 / cfg.aatypes_temp, -1)
        p_curr = torch.gather(probs, -1, aatypes_t[..., None])
        nn_ = cfg.aatypes_noise
        step_probs = d_t * (probs * (1 + nn_ + nn_ * (s - 1) * t) / (1 - t) + nn_ * p_curr)
    step_probs = _regularize_step_probs(step_probs, aatypes_t)
    return _gumbel_argmax(step_probs, gumbel_u)


def _aatypes_euler_step_purity(cfg, d_t, t, logits_1, aatypes_t, res_mask, unmask_u,
                               gumbel_u, remask_u):
    """Purity-ordered unmasking (reference: interpolant.py:347-390): unmask
    the masked positions the model is surest of; how many ~ Binomial(n
    masked, clamp(d_t (1 + noise t) / (1 - t))), as a sum of uniforms; then
    re-mask each position with probability d_t noise."""
    n = logits_1.shape[1]
    probs = torch.softmax(logits_1[..., :-1] / cfg.aatypes_temp, -1)
    is_mask = aatypes_t == MASK_TOKEN_INDEX
    max_logprob = torch.max(torch.log(probs + 1e-12), dim=-1).values
    max_logprob = max_logprob - (~is_mask).float() * 1e9
    # stable, as jnp.argsort: ties keep their index order
    order = torch.argsort(-max_logprob, dim=-1, stable=True)   # best first
    rank = torch.argsort(order, dim=-1, stable=True)

    unmask_prob = torch.clamp(d_t * (1 + cfg.aatypes_noise * t) / (1 - t), 0.0, 1.0)
    n_masked = torch.sum(is_mask, dim=-1)
    number_to_unmask = torch.sum(
        (unmask_u < unmask_prob)
        & (torch.arange(n, device=logits_1.device)[None] < n_masked[:, None]), dim=-1)
    samples = _gumbel_argmax(probs, gumbel_u)
    do_unmask = (rank < number_to_unmask[:, None]) & is_mask
    aatypes_next = torch.where(do_unmask, samples, aatypes_t)
    remask = remask_u < d_t * cfg.aatypes_noise
    return torch.where(remask & res_mask.bool(), MASK_TOKEN_INDEX, aatypes_next).long()


@dataclass
class SE3SampleDraws:
    """The draws of one se3_sample: the prior's trans_noise [B,N,3],
    rot_u [B,N] and rot_axis [B,N,3]; then for each of the steps - 1 Euler
    steps (stacked on a leading axis) gumbel_u [S,B,N,K] (K 20 with purity
    unmasking, else 21) and, with purity unmasking, unmask_u and remask_u
    [S,B,N]. Inside draws.global_rows `draw` makes them at the global
    batch and keeps this rank's rows (axis 0 of the prior's, axis 1 of the
    steps'); `rows` takes those of draws given at the global shape."""
    trans_noise: torch.Tensor
    rot_u: torch.Tensor
    rot_axis: torch.Tensor
    gumbel_u: torch.Tensor
    unmask_u: Optional[torch.Tensor] = None
    remask_u: Optional[torch.Tensor] = None

    @staticmethod
    def draw(cfg: SE3InterpolantConfig, b: int, n: int, steps: int,
             generator: Optional[torch.Generator] = None, device=None) -> "SE3SampleDraws":
        purity = cfg.aatypes_interpolant == "masking" and cfg.aatypes_do_purity
        trans_noise = draws.randn((b, n, 3), generator=generator, device=device)
        rot_u, rot_axis = igso3_draws((b, n), generator, device)
        s = steps - 1
        k = NUM_TOKENS - 1 if purity else NUM_TOKENS
        gumbel_u = draws.rand((s, b, n, k), axis=1, generator=generator, device=device)
        if not purity:
            return SE3SampleDraws(trans_noise, rot_u, rot_axis, gumbel_u)
        unmask_u = draws.rand((s, b, n), axis=1, generator=generator, device=device)
        remask_u = draws.rand((s, b, n), axis=1, generator=generator, device=device)
        return SE3SampleDraws(trans_noise, rot_u, rot_axis, gumbel_u, unmask_u, remask_u)

    def rows(self) -> "SE3SampleDraws":
        """This rank's rows of draws given at the global batch (all of them
        outside draws.global_rows)."""
        return SE3SampleDraws(*(draws.keep(x, axis=0 if i < 3 else 1) for i, x in enumerate(
            (self.trans_noise, self.rot_u, self.rot_axis, self.gumbel_u, self.unmask_u,
             self.remask_u))))


@torch.no_grad()
def se3_sample(cfg: SE3InterpolantConfig, model_fn: Callable, batch_shape, res_mask,
               res_idx=None, num_timesteps: Optional[int] = None,
               draws: Optional[SE3SampleDraws] = None,
               generator: Optional[torch.Generator] = None) -> Dict:
    """Euler-sample backbones and sequences from a FlowModel.

    model_fn(batch dict) -> {'pred_trans', 'pred_rotmats', 'pred_logits'}.
    Returns the final {'trans', 'rotmats', 'aatypes'}: the predictions of
    the last call, at t = 1 (reference: interpolant.py:391-616). Inside
    draws.global_rows the batch is this rank's rows of the global batch
    and `draws`, where given, are the global batch's."""
    b, n = batch_shape
    device = res_mask.device
    steps = num_timesteps or cfg.num_timesteps
    draws = (SE3SampleDraws.draw(cfg, b, n, steps, generator, device) if draws is None
             else draws.rows())
    ts = time_grid(cfg.min_t, steps, device)
    trans = centered_gaussian(draws.trans_noise, res_mask) * cfg.trans_scale
    rotmats = sample_igso3(cfg.igso3_sigma, (b, n), u=draws.rot_u, axis=draws.rot_axis)
    aatypes = torch.full((b, n), MASK_TOKEN_INDEX, dtype=torch.long, device=device)
    if res_idx is None:
        res_idx = torch.arange(n, device=device)[None].expand(b, n)
    purity = cfg.aatypes_interpolant == "masking" and cfg.aatypes_do_purity

    def model_batch(trans, rotmats, aatypes, t_scalar):
        t = t_scalar.expand(b, 1)
        return {"res_mask": res_mask, "res_idx": res_idx,
                "so3_t": t, "r3_t": t, "cat_t": t,
                "trans_t": trans, "rotmats_t": rotmats, "aatypes_t": aatypes,
                "trans_sc": torch.zeros_like(trans),
                "aatypes_sc": F.one_hot(aatypes, NUM_TOKENS).float()}

    for i in range(steps - 1):
        t_1, t_2 = ts[i], ts[i + 1]
        d_t = t_2 - t_1
        out = model_fn(model_batch(trans, rotmats, aatypes, t_1))
        trans = _trans_euler_step(d_t, t_1, out["pred_trans"], trans)
        rotmats = _rots_euler_step(cfg, d_t, t_1, out["pred_rotmats"], rotmats)
        if purity:
            aatypes = _aatypes_euler_step_purity(
                cfg, d_t, t_1, out["pred_logits"], aatypes, res_mask, draws.unmask_u[i],
                draws.gumbel_u[i], draws.remask_u[i])
        else:
            aatypes = _aatypes_euler_step(cfg, d_t, t_1, out["pred_logits"], aatypes,
                                          draws.gumbel_u[i])
        trans = trans * res_mask[..., None]
    out = model_fn(model_batch(trans, rotmats, aatypes, ts[-1]))
    logits = out["pred_logits"]
    if cfg.aatypes_interpolant == "masking":
        logits = logits.clone()
        logits[..., MASK_TOKEN_INDEX] = -1e9
    return {"trans": out["pred_trans"], "rotmats": out["pred_rotmats"],
            "aatypes": torch.argmax(logits, -1)}
