"""SO(3) utilities: exp/log maps, geodesics, IGSO(3) and uniform rotation
sampling. Counterpart of reed_tpu/ops/so3.py (reference:
protein/multiflow/data/so3_utils.py).

  - rotvec_to_rotmat (Rodrigues) / rotmat_to_rotvec (stable log map with a
    Taylor branch near 0 and the pi case from the symmetric part; every
    branch of its `torch.where`s is NaN-free, so gradients stay finite at
    theta = 0 and near pi)
  - calc_rot_vf(mat_t, mat_1) = Log_{mat_t}(mat_1), geodesic_t
  - IGSO(3) sampling by inverse transform over the truncated character
    expansion, from a numpy table (the port's own copy of reed_tpu's)
  - uniform rotations from normalised Gaussian quaternions

Every draw can be handed in (`u`, `axis`, `q`); otherwise it is drawn from
`generator` on `device`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from reed_tpu_torch.parallel import draws


def hat(v):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], -2)


def rotvec_to_rotmat(rotvec, tol: float = 1e-7):
    """Rodrigues' formula with a guarded angle."""
    theta = torch.sqrt(torch.sum(rotvec ** 2, dim=-1) + tol ** 2)
    k = hat(rotvec)
    t = theta[..., None, None]
    sin_term = torch.sin(t) / t
    cos_term = (1.0 - torch.cos(t)) / (t * t)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(k.shape)
    return eye + sin_term * k + cos_term * (k @ k)


def rotmat_to_rotvec(rotmat):
    """Stable, differentiable log map SO(3) -> so(3). The angle comes from
    atan2 (finite gradients, unlike arccos at +-1); each branch of the
    selections is NaN-free, since a where passes 0 * NaN back to the branch
    it did not take."""
    antisym = torch.stack([
        rotmat[..., 2, 1] - rotmat[..., 1, 2],
        rotmat[..., 0, 2] - rotmat[..., 2, 0],
        rotmat[..., 1, 0] - rotmat[..., 0, 1],
    ], dim=-1)
    tr = rotmat[..., 0, 0] + rotmat[..., 1, 1] + rotmat[..., 2, 2]
    cos_theta = (tr - 1.0) / 2.0
    # |antisym| = 2 sin(theta); the guarded root keeps gradients finite at 0
    sin_theta = 0.5 * torch.sqrt(torch.sum(antisym ** 2, dim=-1) + 1e-14)
    theta = torch.atan2(sin_theta, cos_theta)

    # standard branch theta / (2 sin theta) * (R - R^T)^vee, with the
    # small-angle Taylor form 1/2 (1 + theta^2 / 6)
    small = 0.5 * (1.0 + theta ** 2 / 6.0)
    factor = torch.where(theta < 1e-3, small,
                         theta / (2.0 * torch.clamp(sin_theta, min=1e-6)))
    vec_std = antisym * factor[..., None]

    # near-pi branch: R = I + (1 - cos)(a a^T - I), so the diagonal gives a_i^2
    diag = torch.stack([rotmat[..., 0, 0], rotmat[..., 1, 1], rotmat[..., 2, 2]], -1)
    axis2 = torch.clamp((diag - cos_theta[..., None])
                        / torch.clamp(1.0 - cos_theta[..., None], min=1e-6), 0.0, 1.0)
    axis = torch.sqrt(axis2 + 1e-12)
    # signs from the antisymmetric part (which may vanish at exactly pi,
    # where either sign is a valid log)
    sign = torch.where(antisym >= 0, 1.0, -1.0)
    vec_pi = axis * sign * theta[..., None]
    return torch.where((math.pi - theta[..., None]) < 1e-3, vec_pi, vec_std)


def rot_transpose(mat):
    return mat.transpose(-1, -2)


def calc_rot_vf(mat_t, mat_1):
    """Log_{mat_t}(mat_1)."""
    return rotmat_to_rotvec(rot_transpose(mat_t) @ mat_1)


def geodesic_t(t, mat, base_mat, rot_vf=None):
    """Exp_{base}(t * Log_{base}(mat)); t broadcastable with [..., 1]."""
    if rot_vf is None:
        rot_vf = calc_rot_vf(base_mat, mat)
    return base_mat @ rotvec_to_rotmat(t * rot_vf)


# -- IGSO(3) sampling ----------------------------------------------------------

@functools.lru_cache(maxsize=4)
def igso3_inverse_cdf_table(num_sigma: int = 100, num_omega: int = 1024,
                            sigma_min: float = 0.01, sigma_max: float = 2.0,
                            l_max: int = 1000):
    """The inverse-CDF lookup [num_sigma, num_omega] of the IGSO(3) angle
    distribution f(w|s) = sum_l (2l+1) e^{-l(l+1)s^2/2} sin((l+1/2)w) /
    sin(w/2) times the uniform-measure factor (1 - cos w) / pi (numpy, on
    the host); returns (sigmas, table) in f32."""
    sigmas = np.linspace(sigma_min, sigma_max, num_sigma)
    omegas = np.linspace(1e-5, np.pi - 1e-5, num_omega)
    ls = np.arange(l_max + 1)[:, None]
    rows = []
    for s in sigmas:
        coef = (2 * ls + 1) * np.exp(-ls * (ls + 1) * s ** 2 / 2.0)
        series = (coef * np.sin((ls + 0.5) * omegas[None])
                  / np.sin(omegas[None] / 2.0)).sum(0)
        pdf = np.maximum(series, 0.0) * (1 - np.cos(omegas)) / np.pi
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        rows.append(np.interp(np.linspace(0, 1, num_omega), cdf, omegas))
    return sigmas.astype(np.float32), np.stack(rows).astype(np.float32)


def igso3_draws(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                device=None):
    """The draws of sample_igso3: (u [*shape] uniform, axis [*shape, 3]
    normal)."""
    shape = tuple(shape)
    u = draws.rand(shape, generator=generator, device=device)
    axis = draws.randn(shape + (3,), generator=generator, device=device)
    return u, axis


def sample_igso3(sigma: float, shape: Sequence[int], generator: Optional[torch.Generator] = None,
                 device=None, u=None, axis=None):
    """Rotation matrices [*shape, 3, 3] ~ IGSO3(sigma). The table row is the
    first sigma at or above the one asked for (np.searchsorted), and the
    angle the table entry at floor(u * (num_omega - 1))."""
    sigmas, inv_cdf = igso3_inverse_cdf_table()
    si = int(np.clip(np.searchsorted(sigmas, float(sigma)), 0, len(sigmas) - 1))
    if u is None or axis is None:
        u, axis = igso3_draws(shape, generator, device)
    table = torch.from_numpy(inv_cdf[si]).to(u.device)
    idx = torch.clamp((u * (table.shape[0] - 1)).to(torch.int64), 0, table.shape[0] - 1)
    omega = table[idx]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    return rotvec_to_rotmat(axis * omega[..., None])


def quat_to_rotmat(q):
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sample_uniform_rotations(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                             device=None, q=None):
    """Uniform rotations [*shape, 3, 3] from normalised Gaussian quaternions
    q [*shape, 4] (drawn where not given)."""
    if q is None:
        q = torch.randn(tuple(shape) + (4,), generator=generator, device=device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return quat_to_rotmat(q)
