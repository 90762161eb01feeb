"""reed_tpu_torch's protein losses and token corruption against reed_tpu's
(diffusion/protein_losses.py, diffusion/discrete.py) on the CPU, with
reed_tpu's random draws handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import discrete as jd
from reed_tpu.diffusion import protein_losses as jl
from reed_tpu_torch.diffusion import discrete as td
from reed_tpu_torch.diffusion import protein_losses as tl

torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(seed=0, B=2, L=12, K=5, pad=3):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, L, 22)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    mask = np.ones((B, L), np.float32)
    mask[:, L - pad:] = 0.0
    return dict(
        s=rng.integers(0, 21, (B, L)).astype(np.int32), log_probs=log_probs, mask=mask,
        t=rng.uniform(0.01, 0.99, (B, 1)).astype(np.float32),
        e_idx=rng.integers(0, L, (B, L, K)).astype(np.int32),
        mask_residue=(rng.random((B, L)) < 0.5).astype(np.float32) * mask,
        repr_single=rng.standard_normal((B, L, 6)).astype(np.float32),
        repr_pair=rng.standard_normal((B, L, L, 4)).astype(np.float32),
        repr_structure=rng.standard_normal((B, L, 7)).astype(np.float32) * 50,
        zs_single=rng.standard_normal((B, L, 6)).astype(np.float32),
        zs_pair=rng.standard_normal((B, L, K, 4)).astype(np.float32),
        zs_structure=rng.standard_normal((B, L, 7)).astype(np.float32))


def _t(x):
    return torch.tensor(np.asarray(x))


def test_loss_nll_matches_jax():
    x = _inputs()
    ref = jl.loss_nll(x["s"], x["log_probs"], x["mask"])
    got = tl.loss_nll(_t(x["s"]), _t(x["log_probs"]), _t(x["mask"]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("t_schedule", [False, True])
def test_loss_smoothed_matches_jax(t_schedule):
    """Includes the fixed /2000 normalizer (a sum of masked token losses
    over 2000, whatever the batch)."""
    x = _inputs(seed=1)
    ref = jl.loss_smoothed(x["s"], x["log_probs"], x["mask"], 0.1, t=x["t"],
                           t_schedule=t_schedule)
    got = tl.loss_smoothed(_t(x["s"]), _t(x["log_probs"]), _t(x["mask"]), 0.1,
                           t=_t(x["t"]), t_schedule=t_schedule)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL)
    loss = got[0]
    torch.testing.assert_close(got[1], (loss * _t(x["mask"])).sum() / 2000.0)


@pytest.mark.parametrize("repr_norm,repr_noise", [(False, 0.0), (True, 0.0), (True, 0.3)])
def test_loss_repr_matches_jax(repr_norm, repr_noise):
    """Structure target / 100, the pair target gathered along e_idx, the
    masked mean/std (whose variance also sums masked-out positions), and
    target noise: reed_tpu's draws are handed over."""
    x = _inputs(seed=2)
    names = ("repr_single", "repr_pair", "repr_structure", "zs_single", "zs_pair",
             "zs_structure", "e_idx", "mask", "mask_residue")
    rng = jax.random.PRNGKey(4)
    ref = jl.loss_repr(*(jnp.asarray(x[n]) for n in names), rng=rng,
                       repr_norm=repr_norm, repr_noise=repr_noise)
    noise = None
    if repr_noise:
        b, l, k = x["e_idx"].shape
        shapes = [x["repr_single"].shape, (b, l, k, 4), x["repr_structure"].shape]
        noise = [_t(jax.random.normal(r, s)) for r, s in
                 zip(jax.random.split(rng, 3), shapes)]
    got = tl.loss_repr(*(_t(x[n]) for n in names), repr_norm=repr_norm,
                       repr_noise=repr_noise, noise=noise)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL)


def test_repr_noise_draws_from_the_generator():
    x = _inputs(seed=3)
    names = ("repr_single", "repr_pair", "repr_structure", "zs_single", "zs_pair",
             "zs_structure", "e_idx", "mask", "mask_residue")
    args = [_t(x[n]) for n in names]
    a = tl.loss_repr(*args, generator=torch.Generator().manual_seed(0), repr_noise=0.5)
    b = tl.loss_repr(*args, generator=torch.Generator().manual_seed(0), repr_noise=0.5)
    c = tl.loss_repr(*args, repr_noise=0.0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert any((u - v).abs() > 1e-4 for u, v in zip(a, c))


def test_sample_t_and_corruption_match_jax():
    """reed_tpu's corrupt_batch with its uniforms (t's and the tokens') drawn
    as it draws them, handed to the port: identical S_t, t, is_masked."""
    x = _inputs(seed=4)
    cfg = jd.MaskingInterpolantConfig()
    chain_m = np.ones_like(x["mask"])
    chain_m[0, :2] = 0.0
    batch = {"S": x["s"], "mask": x["mask"], "chain_M": chain_m}
    rng = jax.random.PRNGKey(9)
    ref = jd.corrupt_batch(rng, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    rng_t, rng_c = jax.random.split(rng)
    u_t = jax.random.uniform(rng_t, (2,))
    u_c = jax.random.uniform(rng_c, x["s"].shape)
    np.testing.assert_allclose(td.sample_t(2, cfg.min_t, uniforms=_t(u_t)).numpy(),
                               np.asarray(jd.sample_t(rng_t, 2, cfg.min_t)), rtol=0, atol=0)
    t = td.sample_t(2, cfg.min_t, uniforms=_t(u_t))[:, None]
    got = td.corrupt_batch({k: _t(v) for k, v in batch.items()}, td.MaskingInterpolantConfig(),
                           t=t, uniforms=_t(u_c))
    np.testing.assert_array_equal(got["S_t"].numpy(), np.asarray(ref["S_t"]))
    assert got["S_t"].dtype == torch.int32
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), rtol=0, atol=0)
    np.testing.assert_array_equal(got["is_masked"].numpy(), np.asarray(ref["is_masked"]))
    # invalid positions are forced to the mask token
    invalid = (batch["mask"] * batch["chain_M"]) == 0
    assert (got["S_t"].numpy()[invalid] == cfg.mask_index).all()


def test_corruption_draws_from_the_generator():
    s = torch.randint(0, 20, (4, 64), dtype=torch.int32)
    ones = torch.ones(4, 64)
    batch = {"S": s, "mask": ones, "chain_M": ones}
    cfg = td.MaskingInterpolantConfig()
    a = td.corrupt_batch(batch, cfg, torch.Generator().manual_seed(0))
    b = td.corrupt_batch(batch, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a["S_t"], b["S_t"]) and torch.equal(a["t"], b["t"])
    assert ((a["t"] >= cfg.min_t) & (a["t"] <= 1 - cfg.min_t)).all()
    # tokens are masked with probability 1 - t per row
    frac = (a["S_t"] == cfg.mask_index).float().mean(1)
    assert (frac - (1 - a["t"][:, 0])).abs().max() < 0.25
