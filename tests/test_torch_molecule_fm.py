"""reed_tpu_torch's molecular flow matching against reed_tpu's on the CPU:
the host half (prior, Kabsch / Hungarian matching, batch OT, interpolation;
the port's numpy copy) must give bitwise the same arrays for the same numpy
seed; the integrator step (torch) must give the same one-hots and
coordinates to 1e-6 with reed_tpu's jax.random draws injected, for each
categorical strategy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import molecule_fm as jfm
from reed_tpu_torch.diffusion import molecule_fm as tfm

torch.set_num_threads(1)


def _data(seed=0, b=4, n=9, v=6, e=5):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(4, n + 1, size=b)
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)
    idx = np.triu(rng.integers(0, e, size=(b, n, n)), 1)
    return {"coords": rng.standard_normal((b, n, 3)).astype(np.float32) * mask[..., None],
            "atomics": np.eye(v, dtype=np.float32)[rng.integers(0, v, (b, n))],
            "bonds": np.eye(e, dtype=np.float32)[idx + idx.transpose(0, 2, 1)],
            "charges": np.eye(7, dtype=np.float32)[rng.integers(0, 7, (b, n))],
            "mask": mask}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


PRIORS = [dict(), dict(type_noise="dirichlet", bond_noise="uniform-dist", scale_ot=True),
          dict(type_noise="mask", bond_noise="mask", type_mask_index=1, bond_mask_index=4,
               zero_com=False)]


@pytest.mark.parametrize("i", range(len(PRIORS)))
def test_sample_prior_bitwise(i):
    mask = _data()["mask"]
    cfg_j = jfm.MoleculePriorConfig(vocab_size=6, **PRIORS[i])
    cfg_t = tfm.MoleculePriorConfig(vocab_size=6, **PRIORS[i])
    _equal(tfm.sample_prior_batch(np.random.default_rng(3), cfg_t, mask),
           jfm.sample_prior_batch(np.random.default_rng(3), cfg_j, mask))


def test_match_mol_and_batch_ot_bitwise():
    data = _data()
    rng = np.random.default_rng(5)
    noise = rng.standard_normal(data["coords"].shape).astype(np.float32)
    n = int(data["mask"][0].sum())
    np.testing.assert_array_equal(tfm.match_mol(noise[0, :n], data["coords"][0, :n]),
                                  jfm.match_mol(noise[0, :n], data["coords"][0, :n]))
    cols_t, m_t = tfm.batch_ot_permutation(list(noise), list(data["coords"]), data["mask"])
    cols_j, m_j = jfm.batch_ot_permutation(list(noise), list(data["coords"]), data["mask"])
    np.testing.assert_array_equal(cols_t, cols_j)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a, b)


INTERPOLANTS = [dict(coord_noise_std=0.2), dict(batch_ot=True),
                dict(type_interpolation="dirichlet", bond_interpolation="dirichlet",
                     equivariant_ot=False, fixed_time=0.3)]


@pytest.mark.parametrize("i", range(len(INTERPOLANTS)))
def test_interpolate_batch_bitwise(i):
    data = _data()
    prior = dict(vocab_size=6)
    cfg_t = tfm.MoleculeInterpolantConfig(prior=tfm.MoleculePriorConfig(**prior),
                                          **INTERPOLANTS[i])
    cfg_j = jfm.MoleculeInterpolantConfig(prior=jfm.MoleculePriorConfig(**prior),
                                          **INTERPOLANTS[i])
    out_t = tfm.interpolate_batch(np.random.default_rng(7), cfg_t, data)
    out_j = jfm.interpolate_batch(np.random.default_rng(7), cfg_j, data)
    for a, b in zip(out_t, out_j):
        _equal(a, b)


def _jax_draws(key, cfg, curr, predicted):
    """The random numbers reed_tpu's integrator_step draws from `key`, in
    the order integrator_step asks for them."""
    r_coord, r_type, r_bond = jax.random.split(key, 3)
    out = []
    if cfg.coord_noise_std > 0:
        out.append(jax.random.normal(r_coord, curr["coords"].shape))
    for rng_c, strategy, k in ((r_type, cfg.type_strategy, "atomics"),
                               (r_bond, cfg.bond_strategy, "bonds")):
        shape = predicted[k].shape
        if strategy == "uniform-sample":
            out.append(jax.random.uniform(rng_c, shape))
        elif strategy == "mask":
            r1, r2, r3 = jax.random.split(rng_c, 3)
            out += [jax.random.uniform(r1, shape), jax.random.uniform(r2, shape[:-1]),
                    jax.random.uniform(r3, shape[:-1])]
        elif strategy == "dirichlet":
            out.append(jax.random.gamma(rng_c, jnp.maximum(predicted[k] + cfg.eps, 1e-6)))
    return [np.array(d) for d in out]


STRATEGIES = {
    "uniform-sample": dict(cat_noise_level=1.0, coord_noise_std=0.1),
    "mask": dict(type_strategy="mask", bond_strategy="mask", type_mask_index=1,
                 bond_mask_index=4, cat_noise_level=0.5),
    "dirichlet": dict(type_strategy="dirichlet", bond_strategy="dirichlet"),
    "linear": dict(type_strategy="linear", bond_strategy="linear"),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_integrator_step_matches_with_injected_draws(name):
    data = _data(seed=2)
    rng = np.random.default_rng(4)
    prior = jfm.sample_prior_batch(rng, jfm.MoleculePriorConfig(vocab_size=6),
                                   data["mask"])
    b, n = data["mask"].shape

    def soft(shape):
        x = np.exp(rng.standard_normal(shape) * 2)
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    bonds = soft((b, n, n, 5))
    predicted = {"coords": rng.standard_normal((b, n, 3)).astype(np.float32),
                 "atomics": soft((b, n, 6)), "bonds": bonds + bonds.transpose(0, 2, 1, 3)}
    predicted["bonds"] /= predicted["bonds"].sum(-1, keepdims=True)
    t = np.full((b,), 0.37, np.float32)
    step = np.float32(0.01)
    kw = STRATEGIES[name]
    cfg_j, cfg_t = jfm.IntegratorConfig(**kw), tfm.IntegratorConfig(**kw)
    key = jax.random.PRNGKey(11)
    jcurr = {k: jnp.asarray(v) for k, v in prior.items()}
    jpred = {k: jnp.asarray(v) for k, v in predicted.items()}
    ref = jfm.integrator_step(key, cfg_j, jcurr, jpred, jcurr, jnp.asarray(t), step)
    draws = _jax_draws(key, cfg_j, jcurr, jpred)
    tcurr = {k: torch.from_numpy(v) for k, v in prior.items()}
    out = tfm.integrator_step(cfg_t, tcurr, {k: torch.from_numpy(v)
                                             for k, v in predicted.items()},
                              tcurr, torch.from_numpy(t), float(step), draws=draws)
    np.testing.assert_allclose(out["coords"].numpy(), np.asarray(ref["coords"]),
                               rtol=0, atol=1e-6)
    for k in ("atomics", "bonds"):
        if name in ("uniform-sample", "mask"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        else:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    if name != "linear":
        # the sampled bond state stays symmetric
        bo = out["bonds"].numpy()
        np.testing.assert_array_equal(bo, bo.transpose(0, 2, 1, 3))


def test_integrator_step_draws_from_generator():
    """Without injected draws the step draws from the generator: the same
    seed gives the same one-hots, another seed others; leftover or
    misshapen injected draws raise."""
    data = _data(seed=3)
    prior = {k: torch.from_numpy(v) for k, v in tfm.sample_prior_batch(
        np.random.default_rng(1), tfm.MoleculePriorConfig(vocab_size=6),
        data["mask"]).items()}
    pred = {"coords": torch.zeros_like(prior["coords"]),
            "atomics": torch.full_like(prior["atomics"], 1 / 6),
            "bonds": torch.full_like(prior["bonds"], 1 / 5)}
    cfg = tfm.IntegratorConfig(cat_noise_level=1.0)
    t = torch.full((4,), 0.5)
    run = lambda s: tfm.integrator_step(cfg, prior, pred, prior, t, 0.2,  # noqa: E731
                                        generator=torch.Generator().manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["bonds"], b["bonds"]) and not torch.equal(a["bonds"], c["bonds"])
    with pytest.raises(ValueError):
        tfm.integrator_step(cfg, prior, pred, prior, t, 0.2,
                            draws=[torch.rand(prior["atomics"].shape)] * 3)
    with pytest.raises(ValueError):
        tfm.integrator_step(cfg, prior, pred, prior, t, 0.2, draws=[torch.rand(3)] * 2)
