"""reed_tpu_torch samplers: the analytic checks of tests/test_samplers.py
run on the port, and parity with reed_tpu's samplers driving the same tiny
SiT with the same latents, labels and SDE noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import samplers as js
from reed_tpu_torch.diffusion import paths as tp
from reed_tpu_torch.diffusion.samplers import euler_maruyama_sampler, euler_sampler
from torch_parity import tiny_inputs, tiny_pair

torch.set_num_threads(1)

PARITY_ATOL = 1e-4  # f32 model and integrator on both sides; measured ~1e-6


def exact_velocity_model(x, t, y):
    t_b = t.reshape((-1,) + (1,) * (x.dim() - 1))
    return (2 * t_b - 1) / (2 * t_b ** 2 - 2 * t_b + 1) * x


def shifted_model(x, t, y):
    """Label-sensitive: velocity shifted by (y == 1)."""
    shift = (y == 1).float().reshape((-1,) + (1,) * (x.dim() - 1))
    return exact_velocity_model(x, t, y) + shift


def _x1(shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_euler_identity_map():
    x1 = _x1((8, 4, 4, 2))
    x0 = euler_sampler(exact_velocity_model, x1, torch.zeros(8, dtype=torch.long),
                       num_steps=256)
    assert torch.allclose(x0, x1, atol=5e-2)


def test_heun_more_accurate_than_euler():
    x1 = _x1((8, 4, 4, 2))
    y = torch.zeros(8, dtype=torch.long)
    e = euler_sampler(exact_velocity_model, x1, y, num_steps=32)
    h = euler_sampler(exact_velocity_model, x1, y, num_steps=32, heun=True)
    assert (h - x1).abs().mean() < (e - x1).abs().mean()


def test_cfg_noop_when_cond_equals_uncond():
    x1 = _x1((4, 4, 4, 2))
    y = torch.zeros(4, dtype=torch.long)
    a = euler_sampler(exact_velocity_model, x1, y, num_steps=16)
    b = euler_sampler(exact_velocity_model, x1, y, num_steps=16, cfg_scale=2.5,
                      num_classes=10)
    assert torch.allclose(a, b, atol=1e-4)


def test_guidance_interval_restricts_cfg():
    x1 = _x1((4, 4, 4, 2))
    y = torch.ones(4, dtype=torch.long)
    full = euler_sampler(shifted_model, x1, y, num_steps=16, cfg_scale=2.0,
                         num_classes=2)
    windowed = euler_sampler(shifted_model, x1, y, num_steps=16, cfg_scale=2.0,
                             num_classes=2, guidance_low=0.4, guidance_high=0.6)
    none = euler_sampler(shifted_model, x1, y, num_steps=16)
    assert 0 < (windowed - none).abs().mean() < (full - none).abs().mean()


def test_euler_maruyama_marginal():
    x1 = _x1((512, 8))
    x0 = euler_maruyama_sampler(exact_velocity_model, x1,
                                torch.zeros(512, dtype=torch.long),
                                torch.Generator().manual_seed(1), num_steps=128)
    assert abs(float(x0.mean())) < 0.1
    assert abs(float(x0.std()) - 1.0) < 0.1


def test_sampler_determinism():
    x1 = _x1((4, 8))
    y = torch.zeros(4, dtype=torch.long)
    a, b = (euler_maruyama_sampler(exact_velocity_model, x1, y,
                                   torch.Generator().manual_seed(7), num_steps=16)
            for _ in range(2))
    assert torch.equal(a, b)


def test_sde_guidance_interval_restricts_cfg():
    x1 = _x1((4, 4, 4, 2))
    y = torch.ones(4, dtype=torch.long)

    def run(**kw):
        return euler_maruyama_sampler(shifted_model, x1, y,
                                      torch.Generator().manual_seed(3),
                                      num_steps=16, **kw)

    full = run(cfg_scale=2.0, num_classes=2)
    windowed = run(cfg_scale=2.0, num_classes=2, guidance_low=0.4,
                   guidance_high=0.6)
    none = run()
    assert 0 < (windowed - none).abs().mean() < (full - none).abs().mean()
    never = run(cfg_scale=2.0, num_classes=2, guidance_low=1.5, guidance_high=2.0)
    assert torch.allclose(never, none, atol=1e-5)


def test_one_model_call_per_step_and_batch_doubles_only_in_window():
    batches = []

    def model(x, t, y):
        batches.append(x.shape[0])
        return exact_velocity_model(x, t, y)

    x1 = _x1((3, 4))
    y = torch.zeros(3, dtype=torch.long)
    # t grid 1, 0.68, 0.36, 0.04, 0: the window holds 0.68 and 0.36
    euler_maruyama_sampler(model, x1, y, torch.Generator().manual_seed(0),
                           num_steps=4, cfg_scale=2.0, guidance_low=0.3,
                           guidance_high=0.7, num_classes=5)
    assert batches == [3, 6, 6, 3]
    batches.clear()
    # t grid 1, 0.75, 0.5, 0.25, 0; Heun adds a call on all but the last step
    euler_sampler(model, x1, y, num_steps=4, heun=True, cfg_scale=2.0,
                  guidance_low=0.3, guidance_high=0.7, num_classes=5)
    assert batches == [3, 3, 3, 6, 6, 3, 3]


def test_noise_shape_is_checked():
    with pytest.raises(ValueError, match="noise"):
        euler_maruyama_sampler(exact_velocity_model, _x1((2, 3)),
                               torch.zeros(2, dtype=torch.long),
                               num_steps=4, noise=torch.zeros(4, 2, 3))


def test_paths_match_jax():
    from reed_tpu.diffusion import paths as jp

    rng = np.random.default_rng(0)
    v, x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (3, 1)).astype(np.float32)
    for path in ("linear", "cosine"):
        for a, b in zip(tp.interpolant(torch.tensor(t), path), jp.interpolant(t, path)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        s = tp.score_from_velocity(torch.tensor(v), torch.tensor(x), torch.tensor(t), path)
        np.testing.assert_allclose(
            s.numpy(), np.asarray(jp.score_from_velocity(v, x, t, path)), rtol=1e-5)
        back = tp.velocity_from_score(s, torch.tensor(x), torch.tensor(t), path)
        np.testing.assert_allclose(back.numpy(), v, atol=1e-4)
    assert tp.diffusion_coefficient(0.3) == jp.diffusion_coefficient(0.3)


# 4 steps with CFG 2 in the window [0.3, 0.7]: both branches run
GUIDE = dict(num_steps=4, cfg_scale=2.0, guidance_low=0.3, guidance_high=0.7,
             num_classes=10)


def _tiny_model_fns():
    jax_model, variables, model = tiny_pair(std=0.1)

    def jax_fn(x, t, y):
        return jax_model.apply(variables, x, t, y, train=False)[0]

    def torch_fn(x, t, y):
        with torch.no_grad():
            return model(x, t, y)[0]

    x, _, _ = tiny_inputs(batch=2)
    y = np.array([3, 7], np.int32)
    return jax_fn, torch_fn, x, y


@pytest.mark.parametrize("heun", [False, True])
def test_euler_matches_jax(heun):
    jax_fn, torch_fn, x, y = _tiny_model_fns()
    ref = js.euler_sampler(jax_fn, jnp.asarray(x), jnp.asarray(y), heun=heun, **GUIDE)
    out = euler_sampler(torch_fn, torch.tensor(x), torch.tensor(y).long(),
                        heun=heun, **GUIDE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=PARITY_ATOL, rtol=0)


def test_euler_maruyama_matches_jax():
    jax_fn, torch_fn, x, y = _tiny_model_fns()
    rng = jax.random.PRNGKey(5)
    ref = js.euler_maruyama_sampler(jax_fn, jnp.asarray(x), jnp.asarray(y), rng, **GUIDE)
    # the JAX sampler's draw for step i, injected into the port
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i),
                                                   x.shape, jnp.float32))
                      for i in range(GUIDE["num_steps"] - 1)])
    out = euler_maruyama_sampler(torch_fn, torch.tensor(x), torch.tensor(y).long(),
                                 noise=torch.tensor(noise), **GUIDE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=PARITY_ATOL, rtol=0)
