"""reed_tpu_torch's equivariant flow matching (diffusion/efm.py) against
reed_tpu's on the CPU, with the same tiny EGNNDynamics (hidden 32, 2
blocks, batch 3 x 9 atoms with padded rows) and reed_tpu's draws handed to
the port: the loss (l2, the CE categorical loss, without_cat_loss) to 1e-5
of its size; the fixed-grid decode over each path (OT, VP, HB) and method
(rk4, euler), with the cat_loss_step freeze, to 1e-4 of the max against
reed_tpu's decode run op by op; decode_chain;
and sampling, vanilla and with the 'gradient' refinement (coordinates to
1e-4 of their max, types equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import efm as jefm
from reed_tpu_torch.diffusion import efm
from torch_parity import edm_inputs, edm_pair

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
DECODE_RTOL = 1e-4


def _data(seed=2):
    inputs = edm_inputs()
    mask = inputs["node_mask"]
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 5, size=mask.shape[:2])
    d = {"x": inputs["xh"][..., :3], "h_cat": np.eye(5, dtype=np.float32)[types] * mask,
         "h_int": rng.integers(1, 10, size=mask.shape).astype(np.float32) * mask,
         "node_mask": mask, "edge_mask": inputs["edge_mask"], "rep": inputs["rep"]}
    return d, {k: jnp.asarray(v) for k, v in d.items()}, \
        {k: torch.from_numpy(v) for k, v in d.items()}


def _wrappers(**cfg_kw):
    jax_model, params, model = edm_pair(std=0.05)
    jp = jax.tree.map(jnp.asarray, params)

    def jfn(t, z, nm, em, ctx, rep, rng, train):
        return jax_model.apply({"params": jp}, t, z, nm, em, context=ctx, rep=rep)

    def tfn(t, z, nm, em, ctx, rep, train, drop):
        return model(t, z, nm, em, context=ctx, rep=rep)

    cfg_kw = dict(cfg_kw, norm_values=(1.0, 4.0, 10.0))
    return (jefm.EquivariantCNF(jefm.EFMConfig(**cfg_kw), jfn),
            efm.EquivariantCNF(efm.EFMConfig(**cfg_kw), tfn))


@pytest.mark.parametrize("cfg_kw", [{}, dict(cat_loss="ce", cat_loss_weight=0.5),
                                    dict(without_cat_loss=True)],
                         ids=["l2", "ce", "without_cat_loss"])
def test_loss_matches_reed_tpu(cfg_kw):
    jw, tw = _wrappers(**cfg_kw)
    d, j, t = _data()
    key = jax.random.PRNGKey(3)
    want, want_aux = jw.loss(key, j["x"], j["h_cat"], j["h_int"], j["node_mask"],
                             j["edge_mask"], rep=j["rep"])
    # reed_tpu's draws (efm.py loss: split into dequantisation, t, eps, net)
    r_deq, r_t, r_eps, _ = jax.random.split(key, 4)
    r1, r2 = jax.random.split(r_deq)
    b, n = d["x"].shape[:2]
    draw = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    deq = (draw(jax.random.uniform(r1, d["h_cat"].shape)),
           draw(jax.random.uniform(r2, d["h_int"].shape)))
    with torch.no_grad():
        got, aux = tw.loss(t["x"], t["h_cat"], t["h_int"], t["node_mask"], t["edge_mask"],
                           rep=t["rep"], deq_noise=deq, t=draw(jax.random.uniform(r_t, (b,))),
                           eps=draw(jw.sample_combined_noise(r_eps, b, n, j["node_mask"])))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * np.abs(want).max())
    assert set(aux) == set(want_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=LOSS_RTOL)


DECODE_CASES = [dict(discrete_path=p, ode_method=m) for p in ("OT_path", "VP_path", "HB_path")
                for m in ("rk4", "euler")] + [dict(cat_loss_step=0.6, ode_method="euler")]


@pytest.mark.parametrize("cfg_kw", DECODE_CASES,
                         ids=[f"{c.get('discrete_path', 'cat_step')}-{c['ode_method']}"
                              for c in DECODE_CASES])
def test_decode_matches_reed_tpu(cfg_kw):
    jw, tw = _wrappers(ode_steps=5, **cfg_kw)
    d, j, t = _data()
    z = np.array(jw.sample_combined_noise(jax.random.PRNGKey(5), 3, 9, j["node_mask"]))
    # op by op: compiled, XLA evaluates 1 - exp(-T(t)) in vp_scale otherwise,
    # and at the last rk4 stage (t ~ -1.5e-8, where 1 - exp(-T) ~ 0 and M(t)
    # ~ -5000) reed_tpu's jitted decode leaves its own op-by-op value by more
    # than this test's tolerance
    with jax.disable_jit():
        want = np.asarray(jw.decode(jnp.asarray(z), j["node_mask"], j["edge_mask"],
                                    rep=j["rep"]))
    got = tw.decode(torch.from_numpy(z), t["node_mask"], t["edge_mask"], rep=t["rep"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_RTOL * np.abs(want).max())


def test_decode_chain_matches_reed_tpu():
    jw, tw = _wrappers(ode_steps=6)
    d, j, t = _data()
    z = np.array(jw.sample_combined_noise(jax.random.PRNGKey(6), 3, 9, j["node_mask"]))
    want = np.asarray(jw.decode_chain(jnp.asarray(z), j["node_mask"], j["edge_mask"],
                                      rep=j["rep"], keep_frames=3))
    got = tw.decode_chain(torch.from_numpy(z), t["node_mask"], t["edge_mask"], rep=t["rep"],
                          keep_frames=3).numpy()
    assert got.shape == want.shape == (3, 3, 9, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["vanilla", "gradient"])
def test_sample_matches_reed_tpu(method):
    jw, tw = _wrappers(ode_steps=4, sampling_method=method, gradient_refine_steps=5)
    d, j, t = _data()
    rng = jax.random.PRNGKey(9)
    wx, wcat, wint = (np.asarray(a) for a in jw.sample(rng, 3, 9, j["node_mask"],
                                                       j["edge_mask"], rep=j["rep"]))
    r_z, _ = jax.random.split(rng)
    z = torch.from_numpy(np.array(jw.sample_combined_noise(r_z, 3, 9, j["node_mask"])))
    x, cat, charge = tw.sample(3, 9, t["node_mask"], t["edge_mask"], rep=t["rep"], z=z)
    np.testing.assert_allclose(x.numpy(), wx, rtol=0, atol=DECODE_RTOL * np.abs(wx).max())
    np.testing.assert_array_equal(cat.numpy(), wcat)
    np.testing.assert_allclose(charge.numpy(), wint, rtol=0,
                               atol=1.0 + DECODE_RTOL * np.abs(wint).max())
    pad = d["node_mask"][..., 0] == 0
    assert (x.numpy()[pad] == 0).all() and (cat.numpy()[pad] == 0).all()


def test_vp_scale_and_dequantize():
    t = np.linspace(0.01, 1, 7, dtype=np.float32)
    np.testing.assert_allclose(efm.vp_scale(torch.from_numpy(t)).numpy(),
                               np.asarray(jefm.vp_scale(jnp.asarray(t))), rtol=1e-6)
    mask = torch.ones(2, 3, 1)
    mask[1, 2] = 0
    cat, charge = efm.dequantize(torch.ones(2, 3, 4), torch.ones(2, 3, 1), mask,
                                 generator=torch.Generator().manual_seed(0))
    keep = mask[..., 0] == 1
    assert ((cat[keep] - 1).abs() <= 0.5).all() and ((charge[keep] - 1).abs() <= 0.5).all()
    assert (cat[1, 2] == 0).all() and (charge[1, 2] == 0).all()
