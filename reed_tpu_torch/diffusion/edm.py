"""E(n) variational diffusion (EDM) for point-cloud molecules, counterpart of
reed_tpu/diffusion/edm.py (reference:
molecule/equivariant_diffusion/en_diffusion.py).

Predefined (cosine / polynomial) noise schedules as a gamma table on the
device, or the learned VDM schedule (GammaNetwork, the reference's
parameter names); eps-parameterisation; the L2 training loss and the VLB
with t0_always for evaluation, with the zero-CoM subspace corrections;
ancestral sampling p(z_s | z_t) over T steps in a Python loop whose
per-step coefficients are computed once before it, so a step launches the
network and the noise and never waits for the device.

Every draw can be handed in instead of drawn (tests give the port
reed_tpu's): the loss takes `t_int`, `eps`, `eps_0` and the rep-dropout
`drop`; the sampler takes the initial noise, each step's noise and the
final noise (`SampleDraws`). Otherwise they come from a torch.Generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.models.egnn import remove_mean_with_mask
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.draws import keep as keep_rows


# -- noise schedules (reference: en_diffusion.py:23-80, 170-205) -------------

def clip_noise_schedule(alphas2, clip_value: float = 0.001):
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    alphas_step = np.clip(alphas2[1:] / alphas2[:-1], a_min=clip_value, a_max=1.0)
    return np.cumprod(alphas_step, axis=0)


def polynomial_schedule(timesteps: int, s: float = 1e-4, power: float = 2.0):
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    return (1 - 2 * s) * alphas2 + s


def cosine_beta_schedule(timesteps: int, s: float = 0.008):
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = np.clip(1 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), a_min=0, a_max=0.999)
    return np.cumprod(1.0 - betas, axis=0)


def make_gamma_table(noise_schedule: str, timesteps: int,
                     precision: float = 1e-4) -> np.ndarray:
    """-log(alpha^2 / sigma^2) at t = 0, 1/T, ..., 1 (length T + 1), f32."""
    if noise_schedule == "cosine":
        alphas2 = cosine_beta_schedule(timesteps)
    elif noise_schedule.startswith("polynomial"):
        power = float(noise_schedule.split("_")[1])
        alphas2 = polynomial_schedule(timesteps, s=precision, power=power)
    else:
        raise ValueError(noise_schedule)
    sigmas2 = 1 - alphas2
    return (-(np.log(alphas2) - np.log(sigmas2))).astype(np.float32)


def gamma_lookup(gamma_table: torch.Tensor, t, timesteps: int):
    """gamma(t) for t in [0, 1] by the rounded table index."""
    return gamma_table[torch.round(t * timesteps).long()]


class PositiveLinear(nn.Module):
    """F.linear with softplus(weight) (reference: en_diffusion.py:120-145)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, F.softplus(self.weight), self.bias)


class GammaNetwork(nn.Module):
    """The learned monotonic noise schedule (VDM; reference:
    en_diffusion.py:207-245): gamma_tilde(t) = l1(t) + l3(sigmoid(l2(l1(t)))),
    normalised between its values at 0 and 1 onto [gamma_0, gamma_1]."""

    def __init__(self, hidden: int = 1024):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, hidden)
        self.l3 = PositiveLinear(hidden, 1)
        self.gamma_0 = nn.Parameter(torch.tensor([-5.0]))
        self.gamma_1 = nn.Parameter(torch.tensor([10.0]))

    def gamma_tilde(self, t):
        l1 = self.l1(t.reshape(-1, 1))
        return (l1 + self.l3(torch.sigmoid(self.l2(l1))))[..., 0]

    def forward(self, t):
        t = torch.as_tensor(t, dtype=torch.float32, device=self.gamma_0.device)
        g_t = self.gamma_tilde(t)
        g_0 = self.gamma_tilde(torch.zeros((1,), device=t.device))
        g_1 = self.gamma_tilde(torch.ones((1,), device=t.device))
        norm = (g_t - g_0) / (g_1 - g_0)
        return (self.gamma_0 + (self.gamma_1 - self.gamma_0) * norm).reshape(t.shape)


# -- Gaussian helpers (reference: molecule/equivariant_diffusion/utils.py) ----

def sum_except_batch(x):
    return torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def cdf_standard_gaussian(x):
    return 0.5 * (1.0 + torch.erf(x / np.sqrt(2.0)))


def gaussian_kl(q_mu, q_sigma, p_mu, p_sigma, node_mask):
    return sum_except_batch(
        (torch.log(p_sigma / (q_sigma + 1e-20) + 1e-20)
         + 0.5 * (q_sigma ** 2 + (q_mu - p_mu) ** 2) / p_sigma ** 2 - 0.5) * node_mask)


def gaussian_kl_for_dimension(q_mu, q_sigma, p_mu, p_sigma, d):
    mu_norm2 = sum_except_batch((q_mu - p_mu) ** 2)
    return (d * torch.log(p_sigma / (q_sigma + 1e-20) + 1e-20)
            + 0.5 * (d * q_sigma ** 2 + mu_norm2) / p_sigma ** 2 - 0.5 * d)


def combined_noise(shape_x, shape_h, node_mask, generator=None):
    """[z_x | z_h]: z_x ~ N(0, I) on the zero-CoM subspace, z_h ~ N(0, I),
    both masked."""
    dev = node_mask.device
    z_x = draws.randn(shape_x, generator=generator, device=dev) * node_mask
    z_h = draws.randn(shape_h, generator=generator, device=dev) * node_mask
    return torch.cat([remove_mean_with_mask(z_x, node_mask), z_h], dim=-1)


# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EDMConfig:
    n_dims: int = 3
    in_node_nf: int = 6              # one-hot atom types (+ charges)
    include_charges: bool = True
    timesteps: int = 1000
    noise_schedule: str = "polynomial_2"
    noise_precision: float = 1e-5
    loss_type: str = "l2"            # l2 | vlb
    norm_values: Tuple[float, float, float] = (1.0, 4.0, 10.0)
    norm_biases: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cfg_scale: Optional[float] = None


@dataclass
class SampleDraws:
    """The sampler's noise, handed in: `init` [B,N,3+nf], `steps[s]` the
    noise of the step from t = (s+1)/T to s/T, `final` that of p(x | z0)."""

    init: torch.Tensor
    steps: Sequence[torch.Tensor]
    final: torch.Tensor


class EnVariationalDiffusion:
    """EDM around a dynamics function:

    dynamics_fn(t, xh, node_mask, edge_mask, context, rep, train, drop) -> eps
    dynamics_cfg_fn(t, xh, node_mask, edge_mask, context, rep) -> eps (CFG)
    gamma_fn(t) -> gamma (the learned schedule), else the configured table.
    """

    def __init__(self, cfg: EDMConfig, dynamics_fn: Callable,
                 dynamics_cfg_fn: Optional[Callable] = None,
                 gamma_fn: Optional[Callable] = None, device=None):
        self.cfg = cfg
        self.dynamics_fn = dynamics_fn
        self.dynamics_cfg_fn = dynamics_cfg_fn
        self.gamma_fn = gamma_fn
        self.gamma_table = None
        if gamma_fn is None:
            self.gamma_table = torch.from_numpy(make_gamma_table(
                cfg.noise_schedule, cfg.timesteps, cfg.noise_precision)).to(device)

    # -- schedule helpers ---------------------------------------------------
    def gamma(self, t):
        if self.gamma_fn is not None:
            return self.gamma_fn(t)
        return gamma_lookup(self.gamma_table, t, self.cfg.timesteps)

    @staticmethod
    def sigma(gamma):
        return torch.sqrt(torch.sigmoid(gamma))

    @staticmethod
    def alpha(gamma):
        return torch.sqrt(torch.sigmoid(-gamma))

    @staticmethod
    def snr(gamma):
        return torch.exp(-gamma)

    @staticmethod
    def _inflate(arr, target):
        return arr.reshape((arr.shape[0],) + (1,) * (target.dim() - 1))

    def subspace_dimensionality(self, node_mask):
        return (torch.sum(node_mask[..., 0], dim=1) - 1) * self.cfg.n_dims

    # -- normalisation ------------------------------------------------------
    def normalize(self, x, h_cat, h_int, node_mask):
        nv, nb = self.cfg.norm_values, self.cfg.norm_biases
        x = x / nv[0]
        delta_log_px = -self.subspace_dimensionality(node_mask) * np.log(nv[0])
        h_cat = (h_cat.float() - nb[1]) / nv[1] * node_mask
        h_int = (h_int.float() - nb[2]) / nv[2]
        if self.cfg.include_charges:
            h_int = h_int * node_mask
        return x, h_cat, h_int, delta_log_px

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

    # -- losses -------------------------------------------------------------
    def compute_error(self, net_out, eps, train: bool):
        err = sum_except_batch((eps - net_out) ** 2)
        if train and self.cfg.loss_type == "l2":
            return err / ((self.cfg.n_dims + self.cfg.in_node_nf) * eps.shape[1])
        return err

    def kl_prior(self, xh, node_mask):
        gamma_t = self.gamma(torch.ones((xh.shape[0],), device=xh.device))
        mu_t = self._inflate(self.alpha(gamma_t), xh) * xh
        mu_t_x, mu_t_h = mu_t[:, :, :self.cfg.n_dims], mu_t[:, :, self.cfg.n_dims:]
        sigma_t = self.sigma(gamma_t)
        kl_h = gaussian_kl(mu_t_h, self._inflate(sigma_t, mu_t_h), torch.zeros_like(mu_t_h),
                           1.0, node_mask)
        d = self.subspace_dimensionality(node_mask)
        kl_x = gaussian_kl_for_dimension(mu_t_x, sigma_t, torch.zeros_like(mu_t_x), 1.0, d)
        return kl_x + kl_h

    def log_constants_p_x_given_z0(self, x, node_mask):
        dof_x = (torch.sum(node_mask[..., 0], dim=1) - 1) * self.cfg.n_dims
        gamma_0 = self.gamma(torch.zeros((x.shape[0],), device=x.device))
        return dof_x * (-0.5 * gamma_0 - 0.5 * np.log(2 * np.pi))

    def log_pxh_given_z0_without_constants(self, x, h_cat, h_int, z_t, gamma_0, eps,
                                           net_out, node_mask, epsilon: float = 1e-10):
        nd, nv, nb = self.cfg.n_dims, self.cfg.norm_values, self.cfg.norm_biases
        inc = self.cfg.include_charges
        z_h_cat = z_t[:, :, nd:-1] if inc else z_t[:, :, nd:]
        z_h_int = z_t[:, :, -1:] if inc else z_t[:, :, :0]
        sigma_0 = self._inflate(self.sigma(gamma_0), z_t)
        sigma_0_cat, sigma_0_int = sigma_0 * nv[1], sigma_0 * nv[2]
        log_p_x = -0.5 * sum_except_batch((eps[:, :, :nd] - net_out[:, :, :nd]) ** 2)

        h_integer = torch.round(h_int * nv[2] + nb[2])
        onehot = h_cat * nv[1] + nb[1]
        est_int = z_h_int * nv[2] + nb[2]
        est_cat = z_h_cat * nv[1] + nb[1]
        int_centered = h_integer - est_int
        # a floor, not + epsilon: f32 erf cancellation can make the cdf
        # difference slightly negative (~-1e-7), which log turns into NaN
        log_ph_int = torch.log(torch.clamp(
            cdf_standard_gaussian((int_centered + 0.5) / sigma_0_int)
            - cdf_standard_gaussian((int_centered - 0.5) / sigma_0_int), min=epsilon))
        log_ph_int = sum_except_batch(log_ph_int * node_mask)
        centered_cat = est_cat - 1
        log_ph_cat_prop = torch.log(torch.clamp(
            cdf_standard_gaussian((centered_cat + 0.5) / sigma_0_cat)
            - cdf_standard_gaussian((centered_cat - 0.5) / sigma_0_cat), min=epsilon))
        log_probs = log_ph_cat_prop - torch.logsumexp(log_ph_cat_prop, dim=2, keepdim=True)
        log_ph_cat = sum_except_batch(log_probs * onehot * node_mask)
        return log_p_x + log_ph_int + log_ph_cat

    def compute_loss(self, x, h_cat, h_int, node_mask, edge_mask, context, rep,
                     train: bool, t0_always: bool, generator=None, t_int=None,
                     eps=None, eps_0=None, drop=None):
        """(loss [B], denoised xh) (reference: en_diffusion.py:579-707). t_int
        [B, 1] (f32 or int), eps, eps_0 and drop are drawn from `generator`
        where not given."""
        cfg = self.cfg
        b, n = x.shape[:2]
        dev = x.device
        if t_int is None:
            t_int = draws.randint(1 if t0_always else 0, cfg.timesteps + 1, (b, 1),
                                  generator=generator, device=dev)
        t_int = torch.as_tensor(t_int, device=dev).float()
        s = (t_int - 1) / cfg.timesteps
        t = t_int / cfg.timesteps
        t_is_zero = (t_int == 0).float()

        gamma_s, gamma_t = self.gamma(s[:, 0]), self.gamma(t[:, 0])
        alpha_t = self._inflate(self.alpha(gamma_t), x)
        sigma_t = self._inflate(self.sigma(gamma_t), x)
        if eps is None:
            eps = self.sample_combined_noise(b, n, node_mask, generator)
        xh = torch.cat([x, h_cat, h_int], dim=-1)
        z_t = alpha_t * xh + sigma_t * eps

        net_out = self.dynamics_fn(t[:, 0], z_t, node_mask, edge_mask, context, rep,
                                   train, drop)
        error = self.compute_error(net_out, eps, train)
        denoised_xh = (z_t - sigma_t * net_out) / alpha_t
        l2 = train and cfg.loss_type == "l2"
        snr_weight = 1.0 if l2 else self.snr(gamma_s - gamma_t) - 1.0
        loss_t_gt_zero = 0.5 * snr_weight * error
        neg_log_constants = 0.0 if l2 else -self.log_constants_p_x_given_z0(x, node_mask)
        kl_prior = self.kl_prior(xh, node_mask)

        if t0_always:
            estimator = cfg.timesteps * loss_t_gt_zero
            zeros = torch.zeros((b,), device=dev)
            gamma_0 = self.gamma(zeros)
            alpha_0 = self._inflate(self.alpha(gamma_0), x)
            sigma_0 = self._inflate(self.sigma(gamma_0), x)
            if eps_0 is None:
                eps_0 = self.sample_combined_noise(b, n, node_mask, generator)
            z_0 = alpha_0 * xh + sigma_0 * eps_0
            net_out0 = self.dynamics_fn(zeros, z_0, node_mask, edge_mask, context, rep,
                                        train, drop)
            loss_term_0 = -self.log_pxh_given_z0_without_constants(
                x, h_cat, h_int, z_0, gamma_0, eps_0, net_out0, node_mask)
            loss = kl_prior + estimator + neg_log_constants + loss_term_0
        else:
            loss_term_0 = -self.log_pxh_given_z0_without_constants(
                x, h_cat, h_int, z_t, gamma_t, eps, net_out, node_mask)
            loss_t = loss_term_0 * t_is_zero[:, 0] + (1.0 - t_is_zero[:, 0]) * loss_t_gt_zero
            estimator = loss_t if l2 else (cfg.timesteps + 1) * loss_t
            loss = kl_prior + estimator + neg_log_constants
        return loss, denoised_xh

    def loss(self, x, h_cat, h_int, node_mask, edge_mask, context=None, rep=None,
             train: bool = True, **draws):
        """NLL (or the L2 surrogate in training) per molecule, and the
        denoised xh (reference: en_diffusion.py:709-740); `draws` as in
        compute_loss."""
        x, h_cat, h_int, delta_log_px = self.normalize(x, h_cat, h_int, node_mask)
        if train and self.cfg.loss_type == "l2":
            delta_log_px = torch.zeros_like(delta_log_px)
        loss, denoised = self.compute_loss(x, h_cat, h_int, node_mask, edge_mask, context,
                                           rep, train, t0_always=not train, **draws)
        return loss - delta_log_px, denoised

    # -- sampling -----------------------------------------------------------
    def _net_eval(self, t, z, node_mask, edge_mask, context, rep):
        if self.cfg.cfg_scale is not None and self.dynamics_cfg_fn is not None:
            return self.dynamics_cfg_fn(t, z, node_mask, edge_mask, context, rep)
        return self.dynamics_fn(t, z, node_mask, edge_mask, context, rep, False, None)

    def step_coefficients(self, s, t):
        """p(z_s | z_t)'s coefficients for the times s, t ([K] each):
        (alpha_t|s, sigma2_t|s / alpha_t|s / sigma_t, sigma of z_s)."""
        gamma_s, gamma_t = self.gamma(s), self.gamma(t)
        sigma2_t_s = -torch.expm1(F.softplus(gamma_s) - F.softplus(gamma_t))
        alpha_t_s = torch.exp(0.5 * (F.logsigmoid(-gamma_t) - F.logsigmoid(-gamma_s)))
        sigma_s, sigma_t = self.sigma(gamma_s), self.sigma(gamma_t)
        return (alpha_t_s, sigma2_t_s / alpha_t_s / sigma_t,
                torch.sqrt(sigma2_t_s) * sigma_s / sigma_t)

    def sample_p_zs_given_zt(self, s, t, zt, node_mask, edge_mask, context, rep,
                             generator=None, noise=None, coefficients=None):
        """One ancestral step from time t to s (0-d tensors); `coefficients`
        are step_coefficients(s, t), computed here where not given."""
        alpha_t_s, c_eps, sigma = (coefficients if coefficients is not None
                                   else self.step_coefficients(s, t))
        eps_t = self._net_eval(t.expand(zt.shape[0]), zt, node_mask, edge_mask, context, rep)
        mu = zt / alpha_t_s - c_eps * eps_t
        if noise is None:
            noise = self.sample_combined_noise(zt.shape[0], zt.shape[1], node_mask, generator)
        zs = mu + sigma * noise
        nd = self.cfg.n_dims
        return torch.cat([remove_mean_with_mask(zs[:, :, :nd], node_mask), zs[:, :, nd:]],
                         dim=-1)

    def sample_p_xh_given_z0(self, z0, node_mask, edge_mask, context, rep, generator=None,
                             noise=None):
        nd = self.cfg.n_dims
        b = z0.shape[0]
        zeros = torch.zeros((b,), device=z0.device)
        gamma_0 = self.gamma(zeros)
        sigma_x = self._inflate(self.snr(-0.5 * gamma_0), z0)
        net_out = self._net_eval(zeros, z0, node_mask, edge_mask, context, rep)
        alpha_0 = self._inflate(self.alpha(gamma_0), z0)
        sigma_0 = self._inflate(self.sigma(gamma_0), z0)
        mu_x = (z0 - sigma_0 * net_out) / alpha_0
        if noise is None:
            noise = self.sample_combined_noise(b, z0.shape[1], node_mask, generator)
        x = (mu_x + sigma_x * noise)[:, :, :nd]
        inc = self.cfg.include_charges
        num_classes = self.cfg.in_node_nf - int(inc)
        # the types and charges decode from z0, not from the resampled xh
        # (reference en_diffusion.py:501-502): the noise can flip an argmax
        x, h_cat, h_int = self.unnormalize(x, z0[:, :, nd:nd + num_classes],
                                           z0[:, :, -1:] if inc else z0[:, :, :0], node_mask)
        h_cat = F.one_hot(torch.argmax(h_cat, dim=2), num_classes).float() * node_mask
        return x, h_cat, torch.round(h_int) * node_mask

    @torch.no_grad()
    def sample(self, n_samples, n_nodes, node_mask, edge_mask, context=None, rep=None,
               generator=None, draws: Optional[SampleDraws] = None):
        """Ancestral sampling over T steps (reference: en_diffusion.py:793-830)
        -> (x, one-hot h_cat, h_int). The steps' times and coefficients are
        computed on the device before the loop. Inside
        parallel.draws.global_rows the batch is this rank's rows of the
        global batch, and the noise is drawn (or `draws` given) at the
        global batch."""
        cfg = self.cfg
        dev = node_mask.device
        if draws is not None:
            draws = SampleDraws(keep_rows(draws.init), [keep_rows(d) for d in draws.steps],
                                keep_rows(draws.final))
        z = (draws.init if draws is not None
             else self.sample_combined_noise(n_samples, n_nodes, node_mask, generator))
        s_all = torch.arange(cfg.timesteps, device=dev, dtype=torch.float32)
        s_vec, t_vec = s_all / cfg.timesteps, (s_all + 1) / cfg.timesteps
        coefficients = self.step_coefficients(s_vec, t_vec)
        for s_int in range(cfg.timesteps - 1, -1, -1):
            z = self.sample_p_zs_given_zt(
                s_vec[s_int], t_vec[s_int], z, node_mask, edge_mask, context, rep,
                generator, None if draws is None else draws.steps[s_int],
                tuple(c[s_int] for c in coefficients))
        x, h_cat, h_int = self.sample_p_xh_given_z0(
            z, node_mask, edge_mask, context, rep, generator,
            None if draws is None else draws.final)
        return remove_mean_with_mask(x, node_mask), h_cat, h_int
