"""reed_tpu_torch's EDM (diffusion/edm.py) against reed_tpu's on the CPU,
with the same tiny EGNNDynamics (hidden 32, 2 blocks, batch 3 x 9 atoms
with padded rows, seeded-normal weights carried by reed_tpu's converter)
and reed_tpu's own draws handed to the port: the gamma tables (polynomial
and cosine) and the learned GammaNetwork; the L2 training loss, the VLB in
training (with a t = 0 row) and the VLB with t0_always of evaluation, on a
table and on a learned schedule, each to 1e-5 of its size; one ancestral
step; a T = 6 ancestral sample with and without CFG and with the learned
schedule (coordinates and the rounded charges to 1e-4 of their max, the
charges plus one for the rounding; types equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import edm as jedm
from reed_tpu.models.egnn import EGNNDynamics as JaxDynamics
from reed_tpu_torch.diffusion import edm
from reed_tpu_torch.encoders.edm_convert import gamma_state_dict_from_params
from torch_parity import edm_inputs, edm_pair

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
SAMPLE_RTOL = 1e-4


def _data(batch=3, n=9, seed=2):
    inputs = edm_inputs(batch=batch, n=n)
    mask = inputs["node_mask"]
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 5, size=(batch, n))
    return {"x": inputs["xh"][..., :3] * 1.5, "h_cat": np.eye(5, dtype=np.float32)[types] * mask,
            "h_int": rng.integers(1, 10, size=(batch, n, 1)).astype(np.float32) * mask,
            "node_mask": mask, "edge_mask": inputs["edge_mask"], "rep": inputs["rep"]}


def _gamma_params(hidden=16, seed=4):
    params = jedm.GammaNetwork.init_params(hidden=hidden, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # move every leaf off its init so each one matters
    return {k: (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


def _port_gamma(params):
    net = edm.GammaNetwork(hidden=params["l2_w"].shape[1])
    net.load_state_dict(gamma_state_dict_from_params(params))
    return net


def _wrappers(cfg_kw, learned=False, cfg_scale=None):
    """(reed_tpu's EnVariationalDiffusion, the port's) over the same model."""
    jax_model, params, model = edm_pair(in_node_nf=cfg_kw.get("in_node_nf", 6))
    jp = jax.tree.map(jnp.asarray, params)
    jcfg = jedm.EDMConfig(**cfg_kw, cfg_scale=cfg_scale)
    gp = _gamma_params() if learned else None

    def jfn(t, z, nm, em, ctx, rep, rng, train):
        return jax_model.apply({"params": jp}, t, z, nm, em, context=ctx, rep=rep)

    def jcfg_fn(t, z, nm, em, ctx, rep):
        return jax_model.apply({"params": jp}, t, z, nm, em, ctx, rep, cfg_scale,
                               method=JaxDynamics.forward_with_cfg)

    def tfn(t, z, nm, em, ctx, rep, train, drop):
        return model(t, z, nm, em, context=ctx, rep=rep)

    def tcfg_fn(t, z, nm, em, ctx, rep):
        return model.forward_with_cfg(t, z, nm, em, ctx, rep, cfg_scale)

    jw = jedm.EnVariationalDiffusion(
        jcfg, jfn, jcfg_fn,
        gamma_fn=(lambda t: jedm.GammaNetwork.apply(gp, t)) if learned else None)
    tw = edm.EnVariationalDiffusion(edm.EDMConfig(**cfg_kw, cfg_scale=cfg_scale), tfn,
                                    tcfg_fn, gamma_fn=_port_gamma(gp) if learned else None)
    return jw, tw


@pytest.mark.parametrize("schedule,timesteps", [("polynomial_2", 1000), ("cosine", 50),
                                                ("polynomial_3", 7)])
def test_gamma_table_matches(schedule, timesteps):
    want = jedm.make_gamma_table(schedule, timesteps, 1e-5)
    got = edm.make_gamma_table(schedule, timesteps, 1e-5)
    np.testing.assert_array_equal(got, want)
    t = np.linspace(0, 1, 23, dtype=np.float32)
    np.testing.assert_array_equal(
        edm.gamma_lookup(torch.from_numpy(got), torch.from_numpy(t), timesteps).numpy(),
        np.asarray(jedm.gamma_lookup(want, jnp.asarray(t), timesteps)))


def test_gamma_network_matches():
    params = _gamma_params()
    t = np.linspace(0, 1, 11, dtype=np.float32)
    want = np.asarray(jedm.GammaNetwork.apply(params, jnp.asarray(t)))
    with torch.no_grad():
        got = _port_gamma(params)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert got[0] == pytest.approx(params["gamma_0"][0], abs=1e-5)
    assert got[-1] == pytest.approx(params["gamma_1"][0], abs=1e-5)
    assert (np.diff(got) > 0).all()


def _key_with_t_zero(timesteps, batch, lowest=0):
    """A key whose t_int draw has a 0 row (and a nonzero one)."""
    for k in range(500):
        rng_t = jax.random.split(jax.random.PRNGKey(k), 5)[0]
        t = np.asarray(jax.random.randint(rng_t, (batch, 1), lowest, timesteps + 1))
        if lowest > 0 or (0 < (t == 0).sum() < batch):
            return jax.random.PRNGKey(k)
    raise AssertionError("no key")


LOSS_CASES = {
    "l2_train": (dict(timesteps=10), False, True),
    "vlb_train": (dict(timesteps=10, loss_type="vlb"), False, True),
    "vlb_eval_t0_always": (dict(timesteps=10, loss_type="vlb"), False, False),
    "vlb_eval_cosine_no_charges": (dict(timesteps=10, noise_schedule="cosine",
                                        include_charges=False, in_node_nf=5), False, False),
    "vlb_eval_learned": (dict(timesteps=10, loss_type="vlb"), True, False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_reed_tpu(case):
    cfg_kw, learned, train = LOSS_CASES[case]
    cfg_kw = dict(cfg_kw)
    jw, tw = _wrappers(cfg_kw, learned=learned)
    d = _data()
    if not cfg_kw.get("include_charges", True):
        d["h_int"] = d["h_int"][..., :0]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    key = _key_with_t_zero(cfg_kw["timesteps"], 3, lowest=0 if train else 1)
    want, want_den = jw.loss(key, j["x"], j["h_cat"], j["h_int"], j["node_mask"],
                             j["edge_mask"], rep=j["rep"], train=train)
    # reed_tpu's draws (edm.py compute_loss: split into t, eps, eps_0, net, net0)
    rng_t, rng_eps, rng_eps0, _, _ = jax.random.split(key, 5)
    b, n = d["x"].shape[:2]
    draws = {"t_int": np.array(jax.random.randint(rng_t, (b, 1), 0 if train else 1,
                                                    cfg_kw["timesteps"] + 1)),
             "eps": np.array(jw.sample_combined_noise(rng_eps, b, n, j["node_mask"])),
             "eps_0": np.array(jw.sample_combined_noise(rng_eps0, b, n, j["node_mask"]))}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        got, got_den = tw.loss(t["x"], t["h_cat"], t["h_int"], t["node_mask"], t["edge_mask"],
                               rep=t["rep"], train=train,
                               **{k: torch.from_numpy(v) for k, v in draws.items()})
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(want).max())
    np.testing.assert_allclose(got_den.numpy(), np.asarray(want_den), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_den)).max())


def _sample_inputs():
    d = _data()
    return d, {k: jnp.asarray(v) for k, v in d.items()}, \
        {k: torch.from_numpy(v) for k, v in d.items()}


def test_one_ancestral_step_matches():
    jw, tw = _wrappers(dict(timesteps=20))
    d, j, t = _sample_inputs()
    b, n = d["x"].shape[:2]
    zt = np.array(jw.sample_combined_noise(jax.random.PRNGKey(7), b, n, j["node_mask"]))
    rng = jax.random.PRNGKey(8)
    s, tt = np.float32(11) / 20, np.float32(12) / 20
    want = jw.sample_p_zs_given_zt(rng, s, tt, jnp.asarray(zt), j["node_mask"],
                                   j["edge_mask"], None, j["rep"])
    noise = np.array(jw.sample_combined_noise(rng, b, n, j["node_mask"]))
    with torch.no_grad():
        got = tw.sample_p_zs_given_zt(torch.tensor(s), torch.tensor(tt), torch.from_numpy(zt),
                                      t["node_mask"], t["edge_mask"], None, t["rep"],
                                      noise=torch.from_numpy(noise))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["plain", "cfg", "learned"])
def test_full_sample_matches(case):
    timesteps = 6
    jw, tw = _wrappers(dict(timesteps=timesteps), learned=case == "learned",
                       cfg_scale=1.5 if case == "cfg" else None)
    d, j, t = _sample_inputs()
    b, n = d["x"].shape[:2]
    rng = jax.random.PRNGKey(11)
    wx, wcat, wint = (np.asarray(a) for a in jw.sample(rng, b, n, j["node_mask"],
                                                       j["edge_mask"], rep=j["rep"]))
    # reed_tpu's draws (edm.py sample: split into init, scan, final)
    r_init, r_scan, r_final = jax.random.split(rng, 3)
    noise = lambda r: torch.from_numpy(np.array(  # noqa: E731
        jw.sample_combined_noise(r, b, n, j["node_mask"])))
    draws = edm.SampleDraws(init=noise(r_init),
                            steps=[noise(jax.random.fold_in(r_scan, s))
                                   for s in range(timesteps)],
                            final=noise(r_final))
    x, cat, charge = tw.sample(b, n, t["node_mask"], t["edge_mask"], rep=t["rep"],
                               draws=draws)
    np.testing.assert_allclose(x.numpy(), wx, rtol=0, atol=SAMPLE_RTOL * np.abs(wx).max())
    np.testing.assert_array_equal(cat.numpy(), wcat)
    # the untrained net leaves z0 far out (the first step divides by
    # alpha_1|5/6 ~ 0.01), so the charges (round(10 z)) are held like x, to
    # 1e-4 of their max, plus one for the rounding
    np.testing.assert_allclose(charge.numpy(), wint, rtol=0,
                               atol=1.0 + SAMPLE_RTOL * np.abs(wint).max())
    pad = d["node_mask"][..., 0] == 0
    assert (x.numpy()[pad] == 0).all()


def test_sample_draws_from_a_generator():
    """Without handed-in draws the sampler draws from the generator: the
    same seed gives the same molecules, another seed others."""
    _, tw = _wrappers(dict(timesteps=4))
    _, _, t = _sample_inputs()

    def run(seed):
        return tw.sample(3, 9, t["node_mask"], t["edge_mask"], rep=t["rep"],
                         generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
