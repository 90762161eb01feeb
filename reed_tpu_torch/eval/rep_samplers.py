"""Representation samplers for two-stage molecule generation: a global
representation is drawn for each requested atom count, then the point
cloud generator is conditioned on it (GeoRCG/REED). The port's copy of
reed_tpu/eval/rep_samplers.py's GtSampler (reference:
molecule/models/rep_samplers.py:159-226); the RDM samplers (DDIM, PC) are
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def rep_normalization(rep: torch.Tensor) -> torch.Tensor:
    """Per-sample standardisation over the feature dim (reference:
    rep_samplers.py:103-110)."""
    mean = torch.mean(rep, dim=1, keepdim=True)
    std = torch.std(rep, dim=1, keepdim=True, unbiased=False)
    return (rep - mean) / std


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
