"""eval/frechet.py, the port's copy, against reed_tpu/eval/frechet.py: the
same features give the same moments, FID and stats files; numpy f64 on
both sides, so they agree to rounding."""

import numpy as np
import pytest

from reed_tpu.eval import frechet as jax_frechet
from reed_tpu_torch.eval import frechet


def _features(seed, n=300, d=12, shift=0.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.5 + shift


def test_streaming_moments_match():
    x = _features(0)
    port, ref = frechet.StreamingMoments(12), jax_frechet.StreamingMoments(12)
    for i in range(0, 300, 64):
        port.update(x[i:i + 64])
        ref.update(x[i:i + 64])
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.cov, ref.cov)
    np.testing.assert_allclose(port.cov, np.cov(x, rowvar=False), rtol=1e-10, atol=1e-12)
    back = frechet.StreamingMoments.from_state(port.state())
    np.testing.assert_array_equal(back.cov, port.cov)
    assert frechet.StreamingMoments(3).cov.sum() == 0.0


@pytest.mark.parametrize("shift", [0.0, 0.7])
def test_frechet_distance_matches(shift):
    a, b = _features(1), _features(2, shift=shift)
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    got, want = frechet.frechet_distance(*args), jax_frechet.frechet_distance(*args)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12) and got > 0
    assert abs(frechet.frechet_distance(args[0], args[1], args[0], args[1])) < 1e-8


def test_npz_and_activation_stats_match(tmp_path):
    images = np.random.default_rng(4).integers(0, 256, (50, 6, 6, 3), dtype=np.uint8)
    w = np.random.default_rng(5).standard_normal((108, 7)).astype(np.float32)

    def feature_fn(batch):
        return batch.reshape(len(batch), -1).astype(np.float32) @ w

    got = frechet.compute_activation_stats(images, feature_fn, batch_size=16)
    want = jax_frechet.compute_activation_stats(images, feature_fn, batch_size=16)
    for k in ("mu", "sigma"):
        np.testing.assert_array_equal(got[k], want[k])
    np.savez(tmp_path / "a.npz", **got)
    other = frechet.compute_activation_stats(images[::-1][:40], feature_fn, batch_size=9)
    np.savez(tmp_path / "b.npz", **other)
    paths = (str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
    assert frechet.fid_from_npz(*paths) == pytest.approx(jax_frechet.fid_from_npz(*paths),
                                                         rel=1e-12)
