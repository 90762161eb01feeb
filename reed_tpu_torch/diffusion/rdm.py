"""Representation Diffusion Model (RDM): a latent DDPM over frozen-encoder
representation vectors, conditioned on the atom count, with DDPM, DDIM and
predictor-corrector (VPSDE) sampling. Counterpart of
reed_tpu/diffusion/rdm.py (reference: molecule/models/rdm/models/diffusion/
{ddpm,ddim}.py, molecule/models/sde/{sde_lib,sde_sampling}.py).

Every draw can be handed in: t and the noise of the training loss, the
initial noise and each sampler step's noise. Otherwise they come from the
given torch.Generator. The schedule's tables are built in numpy as
reed_tpu builds them and go to the device once, before any loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from reed_tpu_torch.parallel import draws


def make_ldm_linear_betas(timesteps: int, linear_start: float = 0.0015,
                          linear_end: float = 0.0195) -> np.ndarray:
    """ldm's 'linear' schedule: a linspace in sqrt-beta space (reference:
    rdm/modules/diffusionmodules/util.py make_beta_schedule)."""
    return (np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2).astype(np.float32)


@dataclass(frozen=True)
class RDMConfig:
    channels: int = 256
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    parameterization: str = "x0"     # x0 | eps
    v_posterior: float = 0.0
    clip_denoised: bool = False


def rep_normalization(rep: torch.Tensor) -> torch.Tensor:
    """Per-sample standardisation over the feature dim (reference:
    rep_samplers.py:103-110)."""
    mean = torch.mean(rep, dim=1, keepdim=True)
    std = torch.std(rep, dim=1, keepdim=True, unbiased=False)
    return (rep - mean) / std


def _randn(shape, generator, device, given=None):
    if given is not None:
        return torch.as_tensor(given, dtype=torch.float32, device=device)
    return draws.randn(shape, generator=generator, device=device)


class RDMDiffusion:
    """DDPM around model_fn(x_t, t [B] long, n_nodes [B]) -> x0 or eps."""

    def __init__(self, cfg: RDMConfig, model_fn: Callable, device=None):
        self.cfg = cfg
        self.model_fn = model_fn
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        betas = make_ldm_linear_betas(cfg.timesteps, cfg.linear_start, cfg.linear_end)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = (betas * (1.0 - acp_prev) / (1.0 - acp) * (1 - cfg.v_posterior)
                    + cfg.v_posterior * betas).astype(np.float32)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

        self.acp_host = acp.astype(np.float32)
        self.betas = dev(betas)
        self.alphas = dev(alphas)
        self.alphas_cumprod = dev(acp)
        self.sqrt_acp = torch.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_acp = torch.sqrt(1.0 - self.alphas_cumprod)
        self.posterior_variance = dev(post_var)
        self.posterior_log_var = torch.log(torch.clamp(self.posterior_variance, min=1e-20))
        self.posterior_mean_c0 = dev(betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.posterior_mean_ct = dev((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))

    # -- training -------------------------------------------------------
    def q_sample(self, x0, t, noise):
        return self.sqrt_acp[t][:, None] * x0 + self.sqrt_one_minus_acp[t][:, None] * noise

    def training_loss(self, x0, n_nodes, t=None, noise=None,
                      generator: Optional[torch.Generator] = None,
                      model_fn: Optional[Callable] = None):
        """Per-sample MSE on the chosen parameterization (reference: ddpm.py
        p_losses); t ~ U{0..T-1} and the noise drawn from `generator` where
        not given; `model_fn`, where given, takes the place of the
        diffusion's own for this call."""
        b = x0.shape[0]
        if t is None:
            t = draws.randint(0, self.cfg.timesteps, (b,), generator=generator,
                              device=x0.device)
        t = torch.as_tensor(t, device=x0.device).long()
        noise = _randn(x0.shape, generator, x0.device, noise)
        pred = (model_fn or self.model_fn)(self.q_sample(x0, t, noise), t, n_nodes)
        target = x0 if self.cfg.parameterization == "x0" else noise
        return torch.mean((pred - target) ** 2, dim=-1)

    # -- shared ---------------------------------------------------------
    def predict_x0_eps(self, x_t, t, n_nodes):
        pred = self.model_fn(x_t, t, n_nodes)
        a = self.sqrt_acp[t][:, None]
        s = self.sqrt_one_minus_acp[t][:, None]
        if self.cfg.parameterization == "x0":
            x0 = pred
            eps = (x_t - a * x0) / s
        else:
            eps = pred
            x0 = (x_t - s * eps) / a
        if self.cfg.clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0, eps

    def score_fn(self, x_t, t, n_nodes, inv_temp: float = 1.0):
        """The VPSDE's discrete score -eps / sqrt(1 - acp_t), scaled by the
        inverse temperature (reference: sde_lib VPSDE, PCSampler inv_temp)."""
        _, eps = self.predict_x0_eps(x_t, t, n_nodes)
        return -inv_temp * eps / self.sqrt_one_minus_acp[t][:, None]

    def _t(self, b: int, value: int):
        return torch.full((b,), value, dtype=torch.long, device=self.device)

    # -- DDPM ancestral sampling ----------------------------------------
    @torch.no_grad()
    def p_sample_loop(self, shape, n_nodes, generator: Optional[torch.Generator] = None,
                      init=None, noises: Optional[Sequence] = None):
        """Ancestral sampling over t = T-1 .. 0; noises[i] is the noise of
        the step at t = T-1-i (the last, t = 0, adds none)."""
        x = _randn(shape, generator, self.device, init)
        for i, ts in enumerate(range(self.cfg.timesteps - 1, -1, -1)):
            t = self._t(shape[0], ts)
            x0, _ = self.predict_x0_eps(x, t, n_nodes)
            mean = self.posterior_mean_c0[ts] * x0 + self.posterior_mean_ct[ts] * x
            if ts > 0:
                noise = _randn(shape, generator, self.device,
                               None if noises is None else noises[i])
                x = mean + torch.exp(0.5 * self.posterior_log_var[ts]) * noise
            else:
                x = mean
        return x

    # -- DDIM ------------------------------------------------------------
    def ddim_timesteps(self, num_steps: int):
        """The strided timesteps, descending, and alpha_cumprod at each and at
        the next (1 after the last), as reed_tpu's ddim_sample builds them."""
        ts = np.linspace(0, self.cfg.timesteps - 1, num_steps, dtype=np.int64)[::-1].copy()
        ts_prev = np.append(ts[1:], 0)
        acp_t = self.acp_host[ts].astype(np.float32)
        acp_prev = np.where(ts_prev < ts, self.acp_host[ts_prev], 1.0).astype(np.float32)
        acp_prev[-1] = 1.0
        return ts, acp_t, acp_prev

    @torch.no_grad()
    def ddim_sample(self, shape, n_nodes, num_steps: int = 50, eta: float = 0.0,
                    generator: Optional[torch.Generator] = None, init=None,
                    noises: Optional[Sequence] = None):
        """DDIM over a strided timestep subset (reference: ddim.py); with eta
        0 the steps add no noise and draw none."""
        ts, acp_t, acp_prev = self.ddim_timesteps(num_steps)
        a_t_all = torch.from_numpy(acp_t).to(self.device)
        a_prev_all = torch.from_numpy(acp_prev).to(self.device)
        sigma_all = eta * torch.sqrt((1 - a_prev_all) / (1 - a_t_all)
                                     * (1 - a_t_all / a_prev_all))
        x = _randn(shape, generator, self.device, init)
        for i, ts_i in enumerate(ts.tolist()):
            x0, eps = self.predict_x0_eps(x, self._t(shape[0], ts_i), n_nodes)
            a_prev, sigma = a_prev_all[i], sigma_all[i]
            dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
            if eta != 0.0:
                x = x + sigma * _randn(shape, generator, self.device,
                                       None if noises is None else noises[i])
        return x

    # -- predictor-corrector (VPSDE) -------------------------------------
    @torch.no_grad()
    def pc_sample(self, shape, n_nodes, n_corrector_steps: int = 1, snr: float = 0.01,
                  inv_temp: float = 1.0, generator: Optional[torch.Generator] = None,
                  init=None, corrector_noises: Optional[Sequence] = None,
                  predictor_noises: Optional[Sequence] = None):
        """Langevin corrector steps, then the ancestral predictor, at each
        t = T-1 .. 0 (reference: sde_sampling.py AncestralSamplingPredictor
        + LangevinCorrector); corrector_noises[i][j] and predictor_noises[i]
        are the noises of step i (t = T-1-i); the predictor at t = 0 adds
        none."""
        x = _randn(shape, generator, self.device, init)
        for i in range(self.cfg.timesteps):
            ts = self.cfg.timesteps - 1 - i
            t = self._t(shape[0], ts)
            alpha, beta = self.alphas[ts], self.betas[ts]
            for j in range(n_corrector_steps):
                grad = self.score_fn(x, t, n_nodes, inv_temp)
                noise = _randn(shape, generator, self.device,
                               None if corrector_noises is None else corrector_noises[i][j])
                grad_norm = torch.sqrt(torch.mean(torch.sum(grad ** 2, -1)))
                noise_norm = torch.sqrt(torch.mean(torch.sum(noise ** 2, -1)))
                step = (snr * noise_norm / torch.clamp(grad_norm, min=1e-12)) ** 2 * 2 * alpha
                x = x + step * grad + torch.sqrt(2 * step) * noise
            score = self.score_fn(x, t, n_nodes, inv_temp)
            x_mean = (x + beta * score) / torch.sqrt(1.0 - beta)
            if ts > 0:
                noise = _randn(shape, generator, self.device,
                               None if predictor_noises is None else predictor_noises[i])
                x = x_mean + torch.sqrt(beta) * noise
            else:
                x = x_mean
        return x
