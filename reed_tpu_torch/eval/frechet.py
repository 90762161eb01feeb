"""In-repo FID: Frechet distance and streaming feature moments, the port's
own copy of reed_tpu/eval/frechet.py (numpy f64 and scipy's sqrtm):

    FID = |mu_1 - mu_2|^2 + tr(S_1 + S_2 - 2 (S_1 S_2)^{1/2}).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class StreamingMoments:
    """Streaming mean and covariance over feature batches [N, D]."""

    def __init__(self, dim: int):
        self.n = 0
        self._sum = np.zeros((dim,), np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        assert feats.ndim == 2, feats.shape
        self.n += feats.shape[0]
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats

    @property
    def mean(self) -> np.ndarray:
        return self._sum / max(1, self.n)

    @property
    def cov(self) -> np.ndarray:
        """Unbiased sample covariance (np.cov ddof=1, as the ADM suite and
        pytorch-fid use)."""
        if self.n < 2:
            return np.zeros_like(self._outer)
        mu = self.mean
        return (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)

    def state(self):
        return {"n": self.n, "sum": self._sum, "outer": self._outer}

    @classmethod
    def from_state(cls, state):
        out = cls(state["sum"].shape[0])
        out.n = int(state["n"])
        out._sum = np.asarray(state["sum"], np.float64)
        out._outer = np.asarray(state["outer"], np.float64)
        return out


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (pytorch-fid's numerics:
    scipy sqrtm, retried with an eps jitter where it is not finite)."""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_npz(stats1: str, stats2: str) -> float:
    """FID between two stats npz files ({mu, sigma})."""
    a, b = np.load(stats1), np.load(stats2)
    return frechet_distance(a["mu"], a["sigma"], b["mu"], b["sigma"])


def compute_activation_stats(images: np.ndarray, feature_fn,
                             batch_size: int = 64) -> dict:
    """uint8 images [N, H, W, 3] -> {mu, sigma} through feature_fn
    ([B, H, W, 3] uint8 -> [B, D])."""
    moments: Optional[StreamingMoments] = None
    for i in range(0, images.shape[0], batch_size):
        feats = np.asarray(feature_fn(images[i:i + batch_size]))
        if moments is None:
            moments = StreamingMoments(feats.shape[-1])
        moments.update(feats)
    assert moments is not None and moments.n >= 2
    return {"mu": moments.mean, "sigma": moments.cov}
