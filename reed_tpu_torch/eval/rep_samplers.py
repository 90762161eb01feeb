"""Representation samplers for two-stage molecule generation: a global
representation is drawn for each requested atom count, then the point
cloud generator is conditioned on it (GeoRCG/REED). The port's copy of
reed_tpu/eval/rep_samplers.py (reference: molecule/models/
rep_samplers.py:17-360): GtSampler (training-set reps with matching atom
counts), DDIMRepSampler and PCRepSampler (reps sampled from a trained RDM),
each ending in per-sample standardisation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from reed_tpu_torch.diffusion.rdm import RDMDiffusion, rep_normalization


class GtSampler:
    """Ground-truth reps of training molecules with the requested atom
    counts (the nearest count present where one is missing), standardised.
    reps [M, D]: the training set's frozen-encoder reps; num_atoms [M]."""

    def __init__(self, reps: np.ndarray, num_atoms: np.ndarray):
        self.reps = np.asarray(reps)
        self.num_atoms = np.asarray(num_atoms)

    def sample(self, rng: np.random.Generator, nodesxsample: np.ndarray) -> torch.Tensor:
        """[B, D] f32 on the CPU, one rep for each entry of nodesxsample."""
        out = np.zeros((len(nodesxsample), self.reps.shape[1]), np.float32)
        for i, n in enumerate(np.asarray(nodesxsample)):
            idx = np.flatnonzero(self.num_atoms == n)
            if len(idx) == 0:
                nearest = np.argmin(np.abs(self.num_atoms - n))
                idx = np.flatnonzero(self.num_atoms == self.num_atoms[nearest])
            out[i] = self.reps[rng.choice(idx)]
        return rep_normalization(torch.from_numpy(out))


def _torch_generator(rng, device) -> Optional[torch.Generator]:
    """A torch.Generator on `device` from `rng`: itself, or seeded from a
    numpy Generator's next integer (reed_tpu's samplers take a jax key)."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng.integers(2 ** 62)))


class DDIMRepSampler:
    """DDIM over the rep space from a trained RDM (reference:
    rep_samplers.py:112-158)."""

    def __init__(self, diffusion: RDMDiffusion, eta: float = 1.0, step_num: int = 250):
        self.diffusion = diffusion
        self.eta = eta
        self.step_num = step_num

    def sample(self, rng, nodesxsample, **draws) -> torch.Tensor:
        """[B, C] on the diffusion's device; `draws` (init, noises) as
        RDMDiffusion.ddim_sample takes them."""
        dev = self.diffusion.device
        n = torch.as_tensor(np.asarray(nodesxsample), device=dev).long()
        rep = self.diffusion.ddim_sample((n.shape[0], self.diffusion.cfg.channels), n,
                                         num_steps=self.step_num, eta=self.eta,
                                         generator=_torch_generator(rng, dev), **draws)
        return rep_normalization(rep)


class PCRepSampler:
    """Predictor-corrector (VPSDE) sampling with an inverse temperature
    (reference: rep_samplers.py:262-310)."""

    def __init__(self, diffusion: RDMDiffusion, n_steps: int = 1, inv_temp: float = 1.0,
                 snr: float = 0.01):
        self.diffusion = diffusion
        self.n_steps = n_steps
        self.inv_temp = inv_temp
        self.snr = snr

    def sample(self, rng, nodesxsample, **draws) -> torch.Tensor:
        dev = self.diffusion.device
        n = torch.as_tensor(np.asarray(nodesxsample), device=dev).long()
        rep = self.diffusion.pc_sample((n.shape[0], self.diffusion.cfg.channels), n,
                                       n_corrector_steps=self.n_steps, snr=self.snr,
                                       inv_temp=self.inv_temp,
                                       generator=_torch_generator(rng, dev), **draws)
        return rep_normalization(rep)


def initialize_rep_sampler(sampler: str, **kwargs):
    """The reference's initilize_rep_sampler (rep_samplers.py:311-360):
    GtSampler (reps, num_atoms), DDIMSampler (diffusion, eta 1, step_num
    250) or PCSampler (diffusion, n_steps 1, inv_temp 1, snr 0.01)."""
    if sampler == "GtSampler":
        return GtSampler(kwargs["reps"], kwargs["num_atoms"])
    if sampler == "DDIMSampler":
        return DDIMRepSampler(kwargs["diffusion"], eta=kwargs.get("eta", 1.0),
                              step_num=kwargs.get("step_num", 250))
    if sampler == "PCSampler":
        return PCRepSampler(kwargs["diffusion"], n_steps=kwargs.get("n_steps", 1),
                            inv_temp=kwargs.get("inv_temp", 1.0), snr=kwargs.get("snr", 0.01))
    raise ValueError(f"No sampler named {sampler}")
