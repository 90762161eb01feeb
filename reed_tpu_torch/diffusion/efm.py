"""Equivariant flow matching (EFM), the 'fm' probabilistic model of the
molecule EDM path; counterpart of reed_tpu/diffusion/efm.py (reference:
molecule/models/equifm/cnf.py `Cnflows`).

As in reed_tpu: the training loss is conditional flow matching on the OT
path z_t = (1 - t) xh + t eps (t = 1 noise, t = 0 data) with the target
eps - xh, after uniform dequantisation of the categorical and charge
features; decoding integrates the learned field from t = 1 to 0 on a fixed
grid (rk4 or euler) with the reference's VP / HB path scalings and the
cat_loss_step freeze; sampling optionally refines the categorical dims by
the 'gradient' walk near t = 0, then rounds to a one-hot and zero-CoM
coordinates. The loss's draws (dequantisation noise, t, eps, rep dropout)
and the sampler's initial noise can be handed in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch.diffusion.edm import combined_noise, sum_except_batch
from reed_tpu_torch.parallel import draws

BETA_MIN = 0.1
BETA_MAX = 20.0


def T_int(t):
    """Integrated VP-SDE beta: T(t) = int_0^t beta(s) ds (cnf.py:10-14)."""
    return 0.5 * (BETA_MAX - BETA_MIN) * t ** 2 + BETA_MIN * t


def T_hat(t):
    """Instantaneous beta(t) (cnf.py:17-21)."""
    return (BETA_MAX - BETA_MIN) * t + BETA_MIN


def vp_scale(t, eps: float = 1e-5):
    """The VP/HB velocity multiplier M(t) = -beta(t)/2 / (1 - e^{-T(t)})
    (cnf.py:266-277); t a float or a tensor, computed in f32."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return -0.5 * T_hat(t) / (1.0 - torch.exp(-T_int(t)) + eps)


def dequantize(h_cat, h_int, node_mask, generator=None, noise=None):
    """Uniform dequantisation (cnf.py:669-681): U(-0.5, 0.5) added to the
    categorical and integer features, re-masked. `noise` = (u_cat, u_int),
    uniforms on [0, 1), where given."""
    if noise is None:
        noise = (draws.rand(h_cat.shape, generator=generator, device=h_cat.device),
                 draws.rand(h_int.shape, generator=generator, device=h_int.device))
    u_cat, u_int = noise
    return (h_cat + (u_cat - 0.5)) * node_mask, (h_int + (u_int - 0.5)) * node_mask


@dataclass(frozen=True)
class EFMConfig:
    n_dims: int = 3
    in_node_nf: int = 6                    # one-hot atom types (+ charges)
    include_charges: bool = True
    # OT_path: plain velocity; VP_path: the whole field times M(t);
    # HB_path ("hybrid"): only the feature dims (cnf.py:266-277)
    discrete_path: str = "OT_path"
    cat_loss: str = "l2"                   # l2 | ce (extra CE on x0_pred)
    cat_loss_weight: float = 1.0
    without_cat_loss: bool = False         # cnf.py:97 flag
    cat_loss_step: float = -1.0            # freeze the cat dims above this t
    sampling_method: str = "vanilla"       # vanilla | gradient (cnf.py:385)
    gradient_refine_steps: int = 20
    gradient_refine_span: float = 0.05
    ode_steps: int = 100
    ode_method: str = "rk4"                # rk4 | euler (fixed grid)
    norm_values: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0)


class EquivariantCNF:
    """EFM around a dynamics function

    dynamics_fn(t, xh, node_mask, edge_mask, context, rep, train, drop)
        -> velocity field, laid out as xh ([coords | cat | charges])."""

    def __init__(self, cfg: EFMConfig, dynamics_fn: Callable):
        self.cfg = cfg
        self.dynamics_fn = dynamics_fn

    @property
    def _n_cat(self) -> int:
        return self.cfg.in_node_nf - int(self.cfg.include_charges)

    def normalize(self, x, h_cat, h_int, node_mask):
        nv, nb = self.cfg.norm_values, self.cfg.norm_biases
        x = x / nv[0]
        h_cat = (h_cat.float() - nb[1]) / nv[1] * node_mask
        h_int = (h_int.float() - nb[2]) / nv[2]
        if self.cfg.include_charges:
            h_int = h_int * node_mask
        return x, h_cat, h_int

    def unnormalize(self, x, h_cat, h_int, node_mask):
        nv, nb = self.cfg.norm_values, self.cfg.norm_biases
        x = x * nv[0]
        h_cat = (h_cat * nv[1] + nb[1]) * node_mask
        h_int = h_int * nv[2] + nb[2]
        if self.cfg.include_charges:
            h_int = h_int * node_mask
        return x, h_cat, h_int

    def sample_combined_noise(self, b, n, node_mask, generator=None):
        return combined_noise((b, n, self.cfg.n_dims), (b, n, self.cfg.in_node_nf),
                              node_mask, generator)

    # -- training loss --------------------------------------------------------
    def loss(self, x, h_cat, h_int, node_mask, edge_mask, context=None, rep=None,
             train: bool = True, generator=None, deq_noise=None, t=None, eps=None,
             drop=None):
        """Conditional flow matching on the OT path -> (per-molecule loss, aux
        dict). deq_noise, t [B], eps and drop are drawn where not given."""
        cfg = self.cfg
        x, h_cat, h_int = self.normalize(x, h_cat, h_int, node_mask)
        h_cat_d, h_int_d = dequantize(h_cat, h_int, node_mask, generator, deq_noise)
        xh = torch.cat([x, h_cat_d, h_int_d], dim=-1)
        b, n = xh.shape[:2]
        if t is None:
            t = draws.rand((b,), generator=generator, device=xh.device)
        t_b = t[:, None, None]
        if eps is None:
            eps = self.sample_combined_noise(b, n, node_mask, generator)
        z_t = ((1.0 - t_b) * xh + t_b * eps) * node_mask
        target = (eps - xh) * node_mask
        net_out = self.dynamics_fn(t, z_t, node_mask, edge_mask, context, rep, train,
                                   drop) * node_mask

        nd, nc = cfg.n_dims, self._n_cat
        sq = (net_out - target) ** 2
        if cfg.without_cat_loss:
            keep = torch.ones(sq.shape[-1], device=sq.device)
            keep[nd:nd + nc] = 0.0
            sq = sq * keep
        # the mean over the real (masked) dims
        denom = torch.clamp(sum_except_batch(node_mask.expand(sq.shape)), min=1.0)
        loss = sum_except_batch(sq) / denom
        aux = {}
        if cfg.cat_loss == "ce" and not cfg.without_cat_loss:
            # on the OT path z_t - t v_true == xh, so this is the x0 estimate
            x0_pred = z_t - t_b * net_out
            logits = x0_pred[:, :, nd:nd + nc] * cfg.norm_values[1]
            labels = h_cat * cfg.norm_values[1] + cfg.norm_biases[1]
            ce = -(labels * F.log_softmax(logits, dim=-1)).sum(-1, keepdim=True) * node_mask
            ce = sum_except_batch(ce) / torch.clamp(sum_except_batch(node_mask), min=1.0)
            loss = loss + cfg.cat_loss_weight * ce
            aux["cat_ce"] = ce.mean()
        return loss, aux

    # -- decode-time vector field (cnf.py:256-286) ----------------------------
    def wrap_velocity(self, t: float, z, node_mask, edge_mask, context, rep):
        """The learned field at time t (a float) with the cat_loss_step
        freeze / rescale and the VP / HB scalings, as the reference's
        decode wrapper applies them."""
        cfg = self.cfg
        t32 = float(np.float32(t))
        t_vec = torch.full((z.shape[0],), t32, device=z.device)
        dx = self.dynamics_fn(t_vec, z, node_mask, edge_mask, context, rep, False, None)
        nd, nc = cfg.n_dims, self._n_cat
        if cfg.cat_loss_step > 0:
            # compared in f32, as reed_tpu compares its f32 time
            scale = (0.0 if np.float32(t32) > np.float32(cfg.cat_loss_step)
                     else 1.0 / cfg.cat_loss_step)
            dx = torch.cat([dx[:, :, :nd], dx[:, :, nd:nd + nc] * scale, dx[:, :, nd + nc:]],
                           dim=-1)
        if cfg.discrete_path == "VP_path":
            dx = dx * vp_scale(t32).item()
        elif cfg.discrete_path == "HB_path":
            dx = torch.cat([dx[:, :, :nd], dx[:, :, nd:] * vp_scale(t32).item()], dim=-1)
        elif cfg.discrete_path != "OT_path":
            raise ValueError(cfg.discrete_path)
        return dx * node_mask

    # -- fixed-grid ODE integration ------------------------------------------
    def _grid(self):
        """The step times 1 + i dt in f32, as reed_tpu's scan computes them."""
        n = self.cfg.ode_steps
        dt = np.float32(-1.0 / n)
        return [np.float32(1.0) + np.float32(i) * dt for i in range(n)], dt

    @torch.no_grad()
    def decode(self, z, node_mask, edge_mask, context=None, rep=None):
        """Integrate dz/dt = v(t, z) from t = 1 (noise) to t = 0 (data) on a
        fixed grid of cfg.ode_steps steps."""
        cfg = self.cfg
        times, dt = self._grid()
        dt = float(dt)

        def field(t, zz):
            return self.wrap_velocity(t, zz, node_mask, edge_mask, context, rep)

        for t in times:
            t = float(t)
            if cfg.ode_method == "rk4":
                th = float(np.float32(t) + np.float32(0.5 * dt))
                k1 = field(t, z)
                k2 = field(th, z + 0.5 * dt * k1)
                k3 = field(th, z + 0.5 * dt * k2)
                k4 = field(float(np.float32(t) + np.float32(dt)), z + dt * k3)
                z = z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            elif cfg.ode_method == "euler":
                z = z + dt * field(t, z)
            else:
                raise ValueError(cfg.ode_method)
            z = z * node_mask
        return z

    @torch.no_grad()
    def decode_chain(self, z, node_mask, edge_mask, context=None, rep=None,
                     keep_frames: int = 100):
        """Euler decoding that keeps keep_frames intermediate states
        (cnf.py:288-320) -> [frames, B, N, F]."""
        cfg = self.cfg
        frames = []
        per = max(1, cfg.ode_steps // keep_frames)
        dt = -1.0 / cfg.ode_steps
        for i in range(cfg.ode_steps):
            v = self.wrap_velocity(1.0 + i * dt, z, node_mask, edge_mask, context, rep)
            z = (z + dt * v) * node_mask
            if (i + 1) % per == 0 or i == cfg.ode_steps - 1:
                frames.append(z)
        return torch.stack(frames)

    # -- sampling (cnf.py:355-415) ---------------------------------------------
    @torch.no_grad()
    def sample(self, n_samples, n_nodes, node_mask, edge_mask, context=None, rep=None,
               generator=None, z=None):
        """Decode the noise `z` (drawn where not given) -> (x, one-hot h_cat,
        h_int), the schema of EnVariationalDiffusion.sample. Inside
        draws.global_rows the batch is this rank's rows of the global batch
        and `z`, drawn or given, the global batch's."""
        cfg = self.cfg
        if z is None:
            z = self.sample_combined_noise(n_samples, n_nodes, node_mask, generator)
        else:
            z = draws.keep(z)
        z = self.decode(z, node_mask, edge_mask, context, rep)
        nd, nc = cfg.n_dims, self._n_cat
        if cfg.sampling_method == "gradient":
            # categorical refinement: a small forward-Euler walk of the cat
            # dims along the learned field near t = 0 (cnf.py:385-398)
            span, steps = cfg.gradient_refine_span, cfg.gradient_refine_steps
            for t in np.linspace(span, 0.0, steps, dtype=np.float32):
                g = self.dynamics_fn(torch.full((z.shape[0],), float(t), device=z.device), z,
                                     node_mask, edge_mask, context, rep, False, None)
                cat = z[:, :, nd:nd + nc] + g[:, :, nd:nd + nc] * (span / steps)
                z = torch.cat([z[:, :, :nd], cat, z[:, :, nd + nc:]], dim=-1) * node_mask
        elif cfg.sampling_method != "vanilla":
            raise ValueError(cfg.sampling_method)

        h_int = z[:, :, nd + nc:] if cfg.include_charges else z[:, :, :0]
        x, h_cat, h_int = self.unnormalize(z[:, :, :nd], z[:, :, nd:nd + nc], h_int,
                                           node_mask)
        one_hot = F.one_hot(torch.argmax(h_cat, dim=-1), nc).float() * node_mask
        charges = torch.round(h_int) * node_mask if cfg.include_charges else h_int
        # zero-CoG safety projection (cnf.py:407-413)
        npts = torch.clamp(node_mask.sum(dim=1, keepdim=True), min=1.0)
        x = (x - (x * node_mask).sum(dim=1, keepdim=True) / npts) * node_mask
        return x, one_hot, charges
