"""Molecular flow matching (SemlaFlow path), counterpart of
reed_tpu/diffusion/molecule_fm.py: prior sampling, interpolation and the
equivariant / batch OT coupling on the host (numpy, the port's own copy:
the same draws from a numpy Generator as reed_tpu's), and the Euler
Integrator on the device (torch).

Dense padded batches {coords [B,N,3], atomics [B,N,V], bonds [B,N,N,E],
charges [B,N,C], mask [B,N]}; t=0 is prior noise, t=1 is data
(x_t = (1-t) x0 + t x1). The integrator draws its uniforms, normals and
gammas from a torch.Generator, or takes them as `draws` (reed_tpu's
jax.random draws in a parity test).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch.parallel import draws

SCALE_OT_FACTOR = 0.2


# --------------------------------------------------------------------------
# Prior sampling (GeometricNoiseSampler, reference interpolate.py:45-145)

@dataclass(frozen=True)
class MoleculePriorConfig:
    vocab_size: int = 18
    n_bond_types: int = 5
    type_noise: str = "uniform-sample"   # dirichlet|uniform-dist|mask|uniform-sample
    bond_noise: str = "uniform-sample"
    scale_ot: bool = False
    zero_com: bool = True
    type_mask_index: Optional[int] = None
    bond_mask_index: Optional[int] = None


def _sample_categorical_prior(rng: np.random.Generator, shape, n_cats,
                              kind, mask_index):
    if kind == "dirichlet":
        return rng.dirichlet(np.ones(n_cats), size=shape).astype(np.float32)
    if kind == "uniform-dist":
        return np.full(shape + (n_cats,), 1.0 / n_cats, np.float32)
    if kind == "mask":
        out = np.zeros(shape + (n_cats,), np.float32)
        out[..., mask_index] = 1.0
        return out
    if kind == "uniform-sample":
        idx = rng.integers(0, n_cats, size=shape)
        return np.eye(n_cats, dtype=np.float32)[idx]
    raise ValueError(kind)


def sample_prior_batch(rng: np.random.Generator, cfg: MoleculePriorConfig,
                       mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Sample a padded prior batch matching `mask` [B,N]."""
    b, n = mask.shape
    coords = rng.standard_normal((b, n, 3)).astype(np.float32)
    if cfg.scale_ot:
        n_atoms = mask.sum(-1, keepdims=True)[..., None]
        coords = coords * np.log(n_atoms + 1) * SCALE_OT_FACTOR
    coords = coords * mask[..., None]
    if cfg.zero_com:
        coords = _zero_com_np(coords, mask)
    atomics = _sample_categorical_prior(rng, (b, n), cfg.vocab_size,
                                        cfg.type_noise, cfg.type_mask_index)
    bonds = _sample_categorical_prior(rng, (b, n, n), cfg.n_bond_types,
                                      cfg.bond_noise, cfg.bond_mask_index)
    # symmetrize prior bonds so integrators see consistent ij/ji states
    bonds = _symmetrize_onehot(bonds)
    return {"coords": coords,
            "atomics": atomics * mask[..., None],
            "bonds": bonds * (mask[:, :, None] * mask[:, None, :])[..., None],
            "mask": mask.astype(np.float32)}


def _zero_com_np(coords, mask):
    n = np.maximum(mask.sum(-1, keepdims=True), 1.0)[..., None]
    com = (coords * mask[..., None]).sum(-2, keepdims=True) / n
    return (coords - com) * mask[..., None]


def _symmetrize_onehot(bonds):
    """Make a one-hot bond tensor symmetric by copying the upper triangle."""
    n = bonds.shape[1]
    iu = np.triu_indices(n, 1)
    out = bonds.copy()
    out[:, iu[1], iu[0]] = bonds[:, iu[0], iu[1]]
    return out


# --------------------------------------------------------------------------
# OT coupling (host-side; reference interpolate.py:235-280)

def kabsch_rotation(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Rotation matrix R minimizing ||R p - q|| (both zero-CoM, [N,3])."""
    h = p.T @ q
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    return vt.T @ diag @ u.T


def match_mol(from_coords: np.ndarray, to_coords: np.ndarray,
              equivariant: bool = True) -> np.ndarray:
    """Permute (Hungarian on squared distances) then rotate (Kabsch) the
    noise coords to best match the data coords (Equivariant Flow Matching).
    Both [N,3] (unpadded)."""
    from scipy.optimize import linear_sum_assignment

    if not equivariant:
        return from_coords
    cost = ((to_coords[:, None, :] - from_coords[None, :, :]) ** 2).sum(-1)
    _, perm = linear_sum_assignment(cost)
    from_coords = from_coords[perm]
    rot = kabsch_rotation(from_coords, to_coords)
    return from_coords @ rot.T


def batch_ot_permutation(from_batch_coords, to_batch_coords, masks,
                         equivariant: bool = True):
    """Mini-batch OT assignment of prior molecules to data molecules
    (reference: interpolate.py:235-252). Returns (assignment, matched
    coords list)."""
    from scipy.optimize import linear_sum_assignment

    b = len(to_batch_coords)
    matched = [[None] * b for _ in range(b)]
    cost = np.zeros((b, b))
    for i in range(b):
        n_i = int(masks[i].sum())
        to_c = to_batch_coords[i][:n_i]
        for j in range(b):
            from_c = from_batch_coords[j][:n_i]
            m = match_mol(from_c, to_c, equivariant)
            matched[i][j] = m
            cost[i, j] = ((m - to_c) ** 2).sum(-1).mean()
    rows, cols = linear_sum_assignment(cost)
    return cols, [matched[r][c] for r, c in zip(rows, cols)]


# --------------------------------------------------------------------------
# Interpolation (GeometricInterpolant, reference interpolate.py:148-330)

@dataclass(frozen=True)
class MoleculeInterpolantConfig:
    prior: MoleculePriorConfig = MoleculePriorConfig()
    type_interpolation: str = "unmask"   # unmask | dirichlet
    bond_interpolation: str = "unmask"
    coord_noise_std: float = 0.0
    type_dist_temp: float = 1.0
    equivariant_ot: bool = True
    batch_ot: bool = False
    time_alpha: float = 2.0
    time_beta: float = 1.0
    fixed_time: Optional[float] = None


def interpolate_batch(rng: np.random.Generator,
                      cfg: MoleculeInterpolantConfig,
                      data: Dict[str, np.ndarray]
                      ) -> Tuple[Dict, Dict, np.ndarray]:
    """Sample prior, couple (OT), and interpolate. Returns
    (prior, interpolated, times). Host-side numpy (runs in the input
    pipeline, like the reference's collate-time interpolation)."""
    mask = data["mask"]
    b, n = mask.shape
    prior = sample_prior_batch(rng, cfg.prior, mask)

    if cfg.batch_ot:
        cols, matched = batch_ot_permutation(
            [prior["coords"][j] for j in range(b)],
            [data["coords"][i] for i in range(b)], mask, cfg.equivariant_ot)
        prior = {k: (v[cols] if k != "coords" else v) for k, v in prior.items()}
        for i, m in enumerate(matched):
            prior["coords"][i, :m.shape[0]] = m
    elif cfg.equivariant_ot:
        for i in range(b):
            n_i = int(mask[i].sum())
            prior["coords"][i, :n_i] = match_mol(
                prior["coords"][i, :n_i], data["coords"][i, :n_i], True)
            prior["coords"][i, n_i:] = 0.0

    if cfg.fixed_time is not None:
        times = np.full((b,), cfg.fixed_time, np.float32)
    else:
        times = rng.beta(cfg.time_alpha, cfg.time_beta, size=(b,)
                         ).astype(np.float32)

    t = times[:, None, None]
    coords = prior["coords"] * (1 - t) + data["coords"] * t
    coords += rng.standard_normal(coords.shape).astype(np.float32) \
        * cfg.coord_noise_std
    coords = coords * mask[..., None]

    v = data["atomics"].shape[-1]
    if cfg.type_interpolation == "unmask":
        keep_prior = rng.random((b, n)) > times[:, None]
        to_idx = data["atomics"].argmax(-1)
        from_idx = prior["atomics"].argmax(-1)
        idx = np.where(keep_prior, from_idx, to_idx)
        atomics = np.eye(v, dtype=np.float32)[idx]
    elif cfg.type_interpolation == "dirichlet":
        to_soft = _softmax_np(data["atomics"] / cfg.type_dist_temp)
        mean = prior["atomics"] * (1 - t) + to_soft * times[:, None, None]
        atomics = _dirichlet_rows(rng, np.maximum(mean, 1e-6))
    else:
        raise ValueError(cfg.type_interpolation)

    e = data["bonds"].shape[-1]
    if cfg.bond_interpolation == "unmask":
        keep_prior_b = rng.random((b, n, n)) > times[:, None, None]
        keep_prior_b = np.triu(keep_prior_b, 1)
        keep_prior_b = keep_prior_b + keep_prior_b.transpose(0, 2, 1)
        to_idx = data["bonds"].argmax(-1)
        from_idx = prior["bonds"].argmax(-1)
        idx = np.where(keep_prior_b, from_idx, to_idx)
        bonds = np.eye(e, dtype=np.float32)[idx]
    elif cfg.bond_interpolation == "dirichlet":
        to_soft = _softmax_np(data["bonds"] / cfg.type_dist_temp)
        mean = prior["bonds"] * (1 - t[..., None]) \
            + to_soft * times[:, None, None, None]
        bonds = _dirichlet_rows(rng, np.maximum(mean, 1e-6))
    else:
        raise ValueError(cfg.bond_interpolation)

    pair_mask = (mask[:, :, None] * mask[:, None, :])[..., None]
    interpolated = {"coords": coords,
                    "atomics": atomics * mask[..., None],
                    "bonds": bonds * pair_mask,
                    "mask": mask.astype(np.float32)}
    return prior, interpolated, times


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _dirichlet_rows(rng, alpha):
    g = rng.standard_gamma(alpha)
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------------------
# Integrator (device-side; reference fm.py:25-180)

@dataclass(frozen=True)
class IntegratorConfig:
    steps: int = 100
    coord_noise_std: float = 0.0
    type_strategy: str = "uniform-sample"  # linear|dirichlet|mask|uniform-sample
    bond_strategy: str = "uniform-sample"
    cat_noise_level: float = 0.0
    type_mask_index: Optional[int] = None
    bond_mask_index: Optional[int] = None
    eps: float = 1e-5


def _symmetrize_pair_noise(u):
    """Mirror the upper triangle of the two pair axes (1, 2) so a noise
    tensor over (i, j) pairs makes identical decisions for ij and ji.
    Only defined for bond-shaped [B, N, N, ...] tensors."""
    if not (u.dim() >= 3 and u.shape[1] == u.shape[2]):
        raise ValueError(f"symmetric=True requires a square [B, N, N, ...] pair "
                         f"tensor, got {tuple(u.shape)}")
    n = u.shape[1]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=u.device), 1)
    shape = (1, n, n) + (1,) * (u.dim() - 3)
    return torch.where(upper.reshape(shape), u, u.transpose(1, 2))


class _Draws:
    """The integrator's random numbers, in the order reed_tpu splits its
    key: from `generator`, or popped from `given` (a list of tensors in
    the order they are asked for) where that is not None. Inside
    draws.global_rows the batch is this rank's rows of the global batch:
    the uniforms and normals are drawn, or given, at the global batch and
    this rank's rows kept. The gamma draws of the dirichlet strategy are
    not: torch's gamma sampler consumes the generator in a way that depends
    on alpha, so a rank that holds some rows' alpha cannot make the draws
    one process makes for all of them, and it raises there."""

    def __init__(self, generator: Optional[torch.Generator], given=None):
        self.generator = generator
        self.given = None if given is None else list(given)

    def _next(self, make, shape, device):
        if self.given is not None:
            out = draws.keep(torch.as_tensor(self.given.pop(0), device=device).float())
            if tuple(out.shape) != tuple(shape):
                raise ValueError(f"injected draw of shape {tuple(out.shape)}, "
                                 f"the step needs {tuple(shape)}")
            return out
        return make()

    def uniform(self, shape, device):
        return self._next(lambda: draws.rand(shape, generator=self.generator,
                                             device=device), shape, device)

    def normal(self, shape, device):
        return self._next(lambda: draws.randn(shape, generator=self.generator,
                                              device=device), shape, device)

    def gamma(self, alpha):
        if self.given is None and draws.splitting():
            raise NotImplementedError(
                "the dirichlet strategy does not run over several batch indices: its "
                "gamma draws depend on every row's alpha, which a rank holding some rows "
                "does not see (run it with --dp 1 --fsdp 1; --tp splits the model alone)")
        return self._next(lambda: torch._standard_gamma(alpha, generator=self.generator),
                          alpha.shape, alpha.device)


def _pair_uniform(draws, shape, device, symmetric):
    u = draws.uniform(shape, device)
    return _symmetrize_pair_noise(u) if symmetric else u


def _categorical_onehot(draws, probs, symmetric=False):
    """Categorical draw -> one-hot (probs may be unnormalized), as
    argmax(probs / e) with e = -log(u) (the exponential race, reed_tpu's
    form). With symmetric=True the noise is mirrored across the pair axes,
    so symmetric probs yield a symmetric one-hot sample: the training
    interpolant only shows the model symmetric bond states."""
    u = _pair_uniform(draws, probs.shape, probs.device, symmetric)
    e = 1e-10 - torch.log(u + 1e-10)
    idx = torch.argmax(probs / e, dim=-1)
    return F.one_hot(idx, probs.shape[-1]).to(probs.dtype)


def _uniform_sample_step(draws, cfg, curr_dist, pred_dist, t, step_size,
                         symmetric=False):
    """Uniform-sampling DFM step (reference: fm.py:147-173)."""
    n_cats = pred_dist.shape[-1]
    curr = torch.argmax(curr_dist, dim=-1)[..., None]
    pred_probs_curr = torch.gather(pred_dist, -1, curr)
    times = torch.clamp(t.reshape((-1,) + (1,) * (pred_dist.dim() - 1)),
                        cfg.eps, 1.0 - cfg.eps)
    noise = torch.where(times + step_size < 1.0, cfg.cat_noise_level, 0.0)
    mult = (1 + (2 * noise) * (n_cats - 1) * times) / (1 - times)
    step_probs = torch.clamp(step_size * mult * pred_dist
                             + step_size * noise * pred_probs_curr, max=1.0)
    onehot_curr = F.one_hot(curr[..., 0], n_cats).to(pred_dist.dtype)
    step_probs = step_probs * (1 - onehot_curr)
    diag = torch.clamp(1.0 - step_probs.sum(-1, keepdim=True), min=0.0)
    step_probs = step_probs + diag * onehot_curr
    return _categorical_onehot(draws, step_probs, symmetric)


def _mask_sampling_step(draws, cfg, curr_dist, pred_dist, t, mask_index,
                        step_size, symmetric=False):
    """Masking DFM step (reference: fm.py:122-145)."""
    n_cats = pred_dist.shape[-1]
    pred = _categorical_onehot(draws, pred_dist, symmetric).argmax(-1)
    curr = torch.argmax(curr_dist, dim=-1)
    times = t.reshape((-1,) + (1,) * (curr.dim() - 1))
    limit = step_size * (1 + cfg.cat_noise_level * times) / (1 - times)
    unmask = ((_pair_uniform(draws, curr.shape, curr.device, symmetric) < limit)
              & (curr == mask_index))
    mask_new = ((_pair_uniform(draws, curr.shape, curr.device, symmetric)
                 < step_size * cfg.cat_noise_level) & (curr != mask_index))
    mask_new = mask_new & (times + step_size < 1.0)
    out = torch.where(unmask, pred, curr)
    out = torch.where(mask_new, mask_index, out)
    return F.one_hot(out, n_cats).to(pred_dist.dtype)


def integrator_step(cfg: IntegratorConfig, curr, predicted, prior, t, step_size,
                    generator: Optional[torch.Generator] = None, draws=None):
    """One Euler step (reference: fm.py:60-120). curr/predicted/prior are
    dicts of tensors with coords/atomics/bonds (+mask); predicted
    atomics/bonds are probabilities; t [B], step_size a float (taken in
    f32). The random numbers come from `generator`, or from `draws`: a list
    of tensors in the order reed_tpu draws them (the coordinate normal where
    coord_noise_std > 0, then the type step's, then the bond step's; a
    categorical step takes one uniform of the one-hot's shape, the mask
    strategy two more of the index shape, dirichlet one gamma)."""
    source = _Draws(generator, draws)
    step_size = float(np.float32(step_size))
    t_b = t.reshape(-1, 1, 1)
    coord_velocity = (predicted["coords"] - curr["coords"]) / (1 - t_b)
    if cfg.coord_noise_std > 0:
        coord_velocity = coord_velocity + source.normal(
            coord_velocity.shape, coord_velocity.device) * cfg.coord_noise_std
    coords = curr["coords"] + step_size * coord_velocity

    def cat_step(strategy, curr_dist, pred_dist, prior_dist, mask_idx, symmetric):
        # symmetric=True for bonds: the draws are mirrored across the (i, j)
        # pair axes so the sampled bond state stays symmetric (the model
        # symmetrizes its predicted edge logits, so pred_dist is symmetric)
        if strategy == "linear":
            return curr_dist + step_size * (pred_dist - prior_dist)
        if strategy == "dirichlet":
            g = source.gamma(torch.clamp(pred_dist + cfg.eps, min=1e-6))
            if symmetric:
                g = _symmetrize_pair_noise(g)
            return curr_dist + step_size * (g / g.sum(-1, keepdim=True))
        if strategy == "mask":
            return _mask_sampling_step(source, cfg, curr_dist, pred_dist, t,
                                       mask_idx, step_size, symmetric)
        if strategy == "uniform-sample":
            return _uniform_sample_step(source, cfg, curr_dist, pred_dist, t,
                                        step_size, symmetric)
        raise ValueError(strategy)

    atomics = cat_step(cfg.type_strategy, curr["atomics"], predicted["atomics"],
                       prior["atomics"], cfg.type_mask_index, symmetric=False)
    bonds = cat_step(cfg.bond_strategy, curr["bonds"], predicted["bonds"],
                     prior["bonds"], cfg.bond_mask_index, symmetric=True)
    if source.given:
        raise ValueError(f"{len(source.given)} injected draws left over")
    mask = curr["mask"]
    pair_mask = (mask[:, :, None] * mask[:, None, :])[..., None]
    return {"coords": coords * mask[..., None],
            "atomics": atomics * mask[..., None],
            "bonds": bonds * pair_mask,
            "mask": mask}
