"""reed_tpu_torch's reward-guided samplers against reed_tpu's on the CPU:
the particle resampling against jax.random.choice from the same uniforms;
one classifier-gradient guidance term through the tiny ProteinMPNN-FMIF
(the same seeded-normal weights, carried by fmif_convert) against
reed_tpu's jax.grad, to 1e-4 of its max; CG, SMC, TDS and the Gumbel-softmax
sampler through that model with reed_tpu's jax.random draws handed to the
port (tokens equal); the Gumbel sampler's gradient on a bias model; and the
statistical checks of tests/test_reward_guided.py, driven by torch
generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import discrete as jd
from reed_tpu_torch.diffusion import discrete as td
from torch_parity import fmif_args, fmif_batch, tiny_fmif_pair

torch.set_num_threads(1)

V = 22
STEPS = 4
GRAD_RTOL = 1e-4
CFG = td.MaskingInterpolantConfig(num_timesteps=32, min_t=0.01, temp=1.0)


def _fold_uniforms(rng, steps, shape):
    """uniform(fold_in(rng, i), shape) for each step: the draws of reed_tpu's
    CG sampler and of its Gumbel sampler (hard and relaxed alike)."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(rng, i), shape))
                     for i in range(steps)])


def _smc_uniforms(rng, steps, shape):
    """reed_tpu's SMC draws: r1, r2 = split(fold_in(rng, i)); the race takes
    uniform(r1, shape), the resampling uniform(r2, (B,)) (jax.random.choice's
    one uniform a particle)."""
    race, resample = [], []
    for i in range(steps):
        r1, r2 = jax.random.split(jax.random.fold_in(rng, i))
        race.append(np.asarray(jax.random.uniform(r1, shape)))
        resample.append(np.asarray(jax.random.uniform(r2, shape[:1])))
    return np.stack(race), np.stack(resample)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resample_matches_jax_choice(seed):
    b = 16
    weights = np.random.default_rng(seed).uniform(0.05, 1.0, b).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.choice(key, b, shape=(b,), p=jnp.asarray(weights / weights.sum())))
    u = np.asarray(jax.random.uniform(key, (b,)))
    c = np.cumsum(weights / weights.sum())
    # no threshold within 1e-5 of a bin edge: a summation-order difference
    # cannot move an index
    assert np.abs(c[None, :] - (c[-1] * (1 - u))[:, None]).min() > 1e-5
    particles = torch.arange(b) * 10
    (out,) = td._resample(torch.tensor(weights), particles, uniforms=torch.tensor(u))
    np.testing.assert_array_equal(out.numpy(), ref * 10)
    (jout,) = jd._resample(key, jnp.asarray(weights), jnp.arange(b) * 10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def _fmif(fused_jax):
    batch = fmif_batch(batch=3, length=10, seed=5)
    jax_model, variables, model = tiny_fmif_pair(batch, fused=True)
    if not fused_jax:
        jax_model = jax_model.clone(fused=False)  # Pallas interpret mode is slow in a loop
    enc = jax_model.apply(variables, *fmif_args(batch), return_enc=True)

    def jax_logits(s, cls):
        del cls
        return jax_model.apply(variables, *fmif_args(batch, s), enc_state=enc)

    t = {k: torch.tensor(v) for k, v in batch.items()}
    args = (t["X"], t["S"], t["mask"], t["chain_M"], t["residue_idx"], t["chain_encoding_all"])
    with torch.no_grad():
        tenc = model(*args, return_enc=True)

    def port_logits(s, cls):
        del cls
        return model(args[0], s, *args[2:], enc_state=tenc)

    return batch, jax_logits, port_logits


def _linear_reward(seed=3):
    """A seeded linear reward on the (expected) logits, [B, L, V] -> [B]."""
    w = np.random.default_rng(seed).standard_normal(V).astype(np.float32)
    return (lambda x: jnp.mean(x @ jnp.asarray(w), axis=-1),
            lambda x: torch.mean(x @ torch.tensor(w), dim=-1))


def test_cg_guidance_term_matches_jax_grad():
    """d mean R(model(onehot)) / d onehot through the decoder (the fused
    message chains: reed_tpu's Pallas kernels in interpret mode, the port's
    plain versions on the CPU), tokens half decoded."""
    batch, jax_logits, port_logits = _fmif(fused_jax=True)
    jreward, treward = _linear_reward()
    tokens = batch["S"].copy()
    tokens[:, ::2] = 21
    ref = jax.grad(lambda x: jreward(jax_logits(x, None)).mean())(
        jax.nn.one_hot(jnp.asarray(tokens), V))
    ref = np.asarray(ref)
    grad = td.reward_gradient(port_logits, treward, td._onehot(torch.tensor(tokens), V))
    assert np.abs(ref).max() > 1e-5
    err = np.abs(grad.numpy() - ref).max()
    assert err <= GRAD_RTOL * np.abs(ref).max(), err
    # the guidance term itself, as both samplers form it
    jg = 2.0 * (ref - ref[..., 21:22])
    np.testing.assert_allclose(td._guidance(grad, 2.0, 21).numpy(), jg,
                               atol=2 * GRAD_RTOL * np.abs(jg).max())


@pytest.mark.parametrize("sampler", ["cg", "smc", "tds", "gumbel"])
def test_samplers_match_jax(sampler):
    batch, jax_logits, port_logits = _fmif(fused_jax=False)
    jreward, treward = _linear_reward()
    jcfg = jd.MaskingInterpolantConfig(num_timesteps=STEPS + 1)
    tcfg = td.MaskingInterpolantConfig(num_timesteps=STEPS + 1)
    rng = jax.random.PRNGKey(7)
    shape = batch["S"].shape
    if sampler == "cg":
        ref = jd.euler_unmask_sampler_controlled_cg(jax_logits, jreward, rng, shape, jcfg,
                                                    guidance_scale=3.0)
        out = td.euler_unmask_sampler_controlled_cg(
            port_logits, treward, shape, tcfg, guidance_scale=3.0,
            uniforms=torch.tensor(_fold_uniforms(rng, STEPS, shape + (V,))))
    elif sampler in ("smc", "tds"):
        scale = 3.0 if sampler == "tds" else None
        ref = jd.euler_unmask_sampler_controlled_smc(jax_logits, jreward, rng, shape, jcfg,
                                                     alpha=0.5, guidance_scale=scale)
        race, resample = _smc_uniforms(rng, STEPS, shape + (V,))
        out = td.euler_unmask_sampler_controlled_smc(
            port_logits, treward, shape, tcfg, alpha=0.5, guidance_scale=scale,
            uniforms=torch.tensor(race), resample_uniforms=torch.tensor(resample))
    else:
        ref = (None, jd.gumbel_softmax_sampler(jax_logits, rng, shape, jcfg, truncate_steps=2,
                                               gumbel_softmax_temp=0.5))
        out = (None, td.gumbel_softmax_sampler(
            port_logits, shape, tcfg, truncate_steps=2, gumbel_softmax_temp=0.5,
            uniforms=torch.tensor(_fold_uniforms(rng, STEPS, shape + (V,)))))
        np.testing.assert_allclose(out[1].detach().numpy(), np.asarray(ref[1]), atol=1e-6)
        ref = (None, np.argmax(np.asarray(ref[1]), -1))
        out = (None, torch.argmax(out[1], -1))
    for got, want in zip(out, ref):
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (out[1].numpy() != 21).all()


def test_gumbel_gradient_matches_jax():
    """d out[..., 5].mean() / d bias through the relaxed steps of a model
    whose logits are a learnable bias over the vocabulary."""
    cfg_j = jd.MaskingInterpolantConfig(num_timesteps=8, min_t=0.01, temp=1.0)
    cfg_t = td.MaskingInterpolantConfig(num_timesteps=8, min_t=0.01, temp=1.0)
    bias0 = np.random.default_rng(0).standard_normal(V).astype(np.float32)
    rng = jax.random.PRNGKey(0)

    def jloss(bias):
        def model(x, cls):
            return jnp.full(x.shape[:2] + (V,), -8.0) + bias + 2.0 * x
        return jd.gumbel_softmax_sampler(model, rng, (2, 8), cfg_j, truncate_steps=4)[..., 5].mean()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(bias0)))
    bias = torch.tensor(bias0, requires_grad=True)
    out = td.gumbel_softmax_sampler(
        lambda x, cls: torch.full(x.shape[:2] + (V,), -8.0) + bias + 2.0 * x, (2, 8), cfg_t,
        truncate_steps=4, uniforms=torch.tensor(_fold_uniforms(rng, 7, (2, 8, V))))
    (grad,) = torch.autograd.grad(out[..., 5].mean(), bias)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(grad.numpy(), ref, atol=1e-5 * np.abs(ref).max() + 1e-9,
                               rtol=1e-4)


def test_draw_shapes_are_checked():
    with pytest.raises(ValueError, match="uniforms"):
        td.euler_unmask_sampler_controlled_cg(lambda s, c: None, lambda x: None, (2, 3), CFG,
                                              uniforms=torch.zeros(3, 2, 3, V))
    with pytest.raises(ValueError, match="resample_uniforms"):
        td.euler_unmask_sampler_controlled_smc(lambda s, c: None, lambda x: None, (2, 3), CFG,
                                               resample_uniforms=torch.zeros(31, 3))


# -- the statistical checks of tests/test_reward_guided.py, torch generators --

def _onehot_in(x):
    return x.float() if x.dim() == 3 else td._onehot(x, V)


def _two_mode_model(x, cls):
    """Weakly prefers token 3 but gives token 5 as much mass."""
    base = torch.full(x.shape[:2] + (V,), -8.0)
    base[..., 3] = 2.0
    base[..., 5] = 2.0
    return base


def _input_dependent_two_mode_model(x, cls):
    """Two equal modes (3 and 5) with input dependence, so the classifier
    gradient d reward / d x_onehot is nonzero."""
    return _two_mode_model(x, cls) + 5.0 * _onehot_in(x)


def _reward_prefers_5(x):
    return x[..., 5].mean(dim=-1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_cg_guidance_shifts_distribution():
    _, tokens_u = td.euler_unmask_sampler_controlled_cg(
        _input_dependent_two_mode_model, _reward_prefers_5, (8, 24), CFG, guidance_scale=0.0,
        generator=_gen(0))
    _, tokens_g = td.euler_unmask_sampler_controlled_cg(
        _input_dependent_two_mode_model, _reward_prefers_5, (8, 24), CFG,
        guidance_scale=300.0, generator=_gen(0))
    assert float((tokens_g == 5).float().mean()) > float((tokens_u == 5).float().mean()) + 0.1


def test_smc_resampling_shifts_distribution():
    _, plain = td.euler_unmask_sampler_controlled_smc(
        _two_mode_model, _reward_prefers_5, (16, 16), CFG, alpha=1e9, generator=_gen(0))
    _, smc = td.euler_unmask_sampler_controlled_smc(
        _two_mode_model, _reward_prefers_5, (16, 16), CFG, alpha=0.01, generator=_gen(0))
    assert float((smc == 5).float().mean()) >= float((plain == 5).float().mean())


def test_tds_runs_and_is_finite():
    pred, tokens = td.euler_unmask_sampler_controlled_smc(
        _two_mode_model, _reward_prefers_5, (4, 12), CFG, alpha=0.5, guidance_scale=5.0,
        generator=_gen(0))
    assert tokens.shape == pred.shape == (4, 12)
    assert int(tokens.max()) < V


def _frac5(kwargs, n_seeds=5, particles=16, length=16):
    total = 0.0
    for seed in range(n_seeds):
        _, tokens = td.euler_unmask_sampler_controlled_smc(
            _input_dependent_two_mode_model, _reward_prefers_5, (particles, length), CFG,
            generator=_gen(seed), **kwargs)
        total += float((tokens == 5).float().mean())
    return total / n_seeds


def test_tds_concentrates_on_rewarded_mode():
    frac_unguided = _frac5(dict(alpha=1e9, guidance_scale=None))
    frac_tds = _frac5(dict(alpha=0.05, guidance_scale=20.0))
    assert frac_tds > frac_unguided + 0.2, (frac_tds, frac_unguided)
    assert 0.3 < frac_unguided < 0.7


def test_tds_beats_plain_smc_at_small_particle_count():
    kwargs = dict(n_seeds=8, particles=4, length=16)
    frac_smc = _frac5(dict(alpha=0.05, guidance_scale=None), **kwargs)
    frac_tds = _frac5(dict(alpha=0.05, guidance_scale=20.0), **kwargs)
    assert frac_tds > frac_smc + 0.05, (frac_tds, frac_smc)


def test_gumbel_softmax_sampler_differentiable():
    cfg = td.MaskingInterpolantConfig(num_timesteps=8, min_t=0.01, temp=1.0)
    bias = torch.zeros(V, requires_grad=True)
    out = td.gumbel_softmax_sampler(lambda x, cls: torch.full(x.shape[:2] + (V,), -8.0) + bias,
                                    (2, 8), cfg, truncate_steps=4, generator=_gen(0))
    (g,) = torch.autograd.grad(out[..., 5].mean(), bias)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_gumbel_sampler_output_is_onehot():
    cfg = td.MaskingInterpolantConfig(num_timesteps=8, min_t=0.01, temp=1.0)

    def model(x, cls):
        base = torch.full(x.shape[:2] + (V,), -8.0)
        base[..., 3] = 8.0
        return base

    out = td.gumbel_softmax_sampler(model, (2, 8), cfg, truncate_steps=2, generator=_gen(0))
    np.testing.assert_allclose(out.detach().sum(-1).numpy(), 1.0, atol=1e-4)
    assert int(out[..., td.MASK_TOKEN_INDEX].sum()) == 0
