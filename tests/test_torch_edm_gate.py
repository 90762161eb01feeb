"""The EDM convergence gate's sampler and scorer against reed_tpu's, at the
gate's configuration (reed_tpu_torch/tools/convergence_edm.py gate_config:
T = 1000, the polynomial_2 schedule at precision 1e-5, the chain family's
5 types with charges, 64-d reps, no rep dropout), narrowed to hidden 32 and
2 layers, the same seeded weights in both packages (reed_tpu's converter):

- the gamma table at all 1,001 points, bitwise, and its lookup there;
- every one of the 1,000 ancestral steps, teacher-forced: reed_tpu's z_t
  and its step noise handed to both packages' sample_p_zs_given_zt at each
  (s, t), the port's step with the coefficients its sampler computes for
  the whole chain, each z_s within 1e-5 of its largest magnitude;
- the final p(x | z0) step from reed_tpu's z0;
- with and without classifier-free guidance (with the null rep of rep
  dropout 0.1, which guidance needs);
- MoleculeMetrics.evaluate (the gate's scorer, as score() builds it) on
  jittered chain molecules whose validity lands between 0.3 and 0.9,
  equal to reed_tpu's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import edm as jedm
from reed_tpu.eval import molecule_metrics as jmetrics
from reed_tpu.models.egnn import EGNNDynamics as JaxDynamics
from reed_tpu_torch.diffusion import edm
from reed_tpu_torch.eval import molecule_metrics as metrics
from reed_tpu_torch.tools.convergence_edm import GateData, gate_config
from reed_tpu_torch.train.molecule_edm import edm_config
from torch_parity import edm_pair

torch.set_num_threads(1)
STEP_RTOL = 1e-5    # as tests/test_torch_edm.py's one ancestral step
SAMPLE_RTOL = 1e-4  # as its full samples
BATCH = 3


def _gate_pair(cfg_scale):
    """(reed_tpu's and the port's EnVariationalDiffusion over the narrowed
    gate model, the port's EDMConfig)."""
    cfg = gate_config(hidden=32, layers=2)
    pcfg = edm_config(cfg, cfg_scale)
    kw = {k: getattr(cfg, k) for k in ("hidden_nf", "n_layers", "inv_sublayers", "attention",
                                       "tanh", "coords_range", "normalization_factor",
                                       "aggregation", "rep_nf")}
    # guidance needs the null rep that rep dropout trains (the gate trains
    # without it, MoleculeEDMConfig's default with it: 0.1)
    kw["rep_dropout_prob"] = 0.1 if cfg_scale else cfg.rep_dropout_prob
    jax_model, params, model = edm_pair(in_node_nf=pcfg.in_node_nf, **kw)
    jp = jax.tree.map(jnp.asarray, params)

    def jfn(t, z, nm, em, ctx, rep, rng, train):
        return jax_model.apply({"params": jp}, t, z, nm, em, context=ctx, rep=rep)

    def jcfg_fn(t, z, nm, em, ctx, rep):
        return jax_model.apply({"params": jp}, t, z, nm, em, ctx, rep, cfg_scale,
                               method=JaxDynamics.forward_with_cfg)

    def tfn(t, z, nm, em, ctx, rep, train, drop):
        return model(t, z, nm, em, context=ctx, rep=rep)

    def tcfg_fn(t, z, nm, em, ctx, rep):
        return model.forward_with_cfg(t, z, nm, em, ctx, rep, cfg_scale)

    jw = jedm.EnVariationalDiffusion(jedm.EDMConfig(**dataclasses.asdict(pcfg)), jfn, jcfg_fn)
    tw = edm.EnVariationalDiffusion(pcfg, tfn, tcfg_fn)
    return jw, tw, pcfg


def _inputs():
    """Three molecules of random chain classes, their masks and reps, as the
    gate's score() builds them."""
    data = GateData()
    cls = np.random.default_rng(20_000).integers(0, len(data.family), size=BATCH)
    sizes = np.array([len(data.family[i]["types"]) for i in cls])
    mask = (np.arange(data.max_n)[None, :] < sizes[:, None]).astype(np.float32)[..., None]
    edge = mask[:, :, None, :] * mask[:, None, :, :] * (
        1 - np.eye(data.max_n, dtype=np.float32)[None, :, :, None])
    return {"node_mask": mask, "edge_mask": edge, "rep": data.class_embs[cls]}


def test_gamma_table_at_every_point():
    pcfg = edm_config(gate_config())
    assert (pcfg.timesteps, pcfg.noise_schedule, pcfg.noise_precision) == (
        1000, "polynomial_2", 1e-5)
    want = jedm.make_gamma_table(pcfg.noise_schedule, pcfg.timesteps, pcfg.noise_precision)
    got = edm.make_gamma_table(pcfg.noise_schedule, pcfg.timesteps, pcfg.noise_precision)
    assert got.shape == (1001,)
    np.testing.assert_array_equal(got, want)
    t = np.arange(1001, dtype=np.float32) / np.float32(1000)
    np.testing.assert_array_equal(
        edm.gamma_lookup(torch.from_numpy(got), torch.from_numpy(t), 1000).numpy(),
        np.asarray(jedm.gamma_lookup(want, jnp.asarray(t), 1000)))


@pytest.mark.parametrize("cfg_scale", [None, 1.5], ids=["plain", "cfg"])
def test_every_ancestral_step_and_the_last(cfg_scale):
    jw, tw, pcfg = _gate_pair(cfg_scale)
    d = _inputs()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    b, n = d["node_mask"].shape[:2]
    timesteps = pcfg.timesteps
    rng_init, rng_scan, rng_final = jax.random.split(jax.random.PRNGKey(11), 3)

    @jax.jit
    def jstep(rng, s, tt, z):
        zs = jw.sample_p_zs_given_zt(rng, s, tt, z, j["node_mask"], j["edge_mask"], None,
                                     j["rep"])
        return zs, jw.sample_combined_noise(rng, b, n, j["node_mask"])

    z = jw.sample_combined_noise(rng_init, b, n, j["node_mask"])
    # the port's sampler's times and coefficients, for the whole chain at once
    s_all = torch.arange(timesteps, dtype=torch.float32)
    s_vec, t_vec = s_all / timesteps, (s_all + 1) / timesteps
    coefficients = tw.step_coefficients(s_vec, t_vec)
    worst = 0.0
    with torch.no_grad():
        for s_int in range(timesteps - 1, -1, -1):
            s, tt = np.float32(s_int) / timesteps, np.float32(s_int + 1) / timesteps
            assert (s_vec[s_int].item(), t_vec[s_int].item()) == (s, tt)
            want, noise = jstep(jax.random.fold_in(rng_scan, s_int), s, tt, z)
            want = np.asarray(want)
            got = tw.sample_p_zs_given_zt(
                s_vec[s_int], t_vec[s_int], torch.from_numpy(np.array(z)), t["node_mask"],
                t["edge_mask"], None, t["rep"], noise=torch.from_numpy(np.array(noise)),
                coefficients=tuple(c[s_int] for c in coefficients)).numpy()
            assert np.isfinite(got).all(), s_int
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= STEP_RTOL, (s_int, err)
            worst = max(worst, err)
            z = jnp.asarray(want)
        wx, wcat, wint = (np.asarray(a) for a in jw.sample_p_xh_given_z0(
            rng_final, z, j["node_mask"], j["edge_mask"], None, j["rep"]))
        noise = np.array(jw.sample_combined_noise(rng_final, b, n, j["node_mask"]))
        x, cat, charge = tw.sample_p_xh_given_z0(
            torch.from_numpy(np.array(z)), t["node_mask"], t["edge_mask"], None, t["rep"],
            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(x.numpy(), wx, rtol=0, atol=SAMPLE_RTOL * np.abs(wx).max())
    np.testing.assert_array_equal(cat.numpy(), wcat)
    np.testing.assert_allclose(charge.numpy(), wint, rtol=0,
                               atol=1.0 + SAMPLE_RTOL * np.abs(wint).max())
    assert worst > 0.0  # the steps ran in two packages, not one


def _jittered_chains(n=60, seed=0):
    """Chain molecules of the gate's family (QM9 decoder indices), each
    jittered by a seeded normal of a scale up to 0.1 A, which breaks about
    half of them (validity 0.42)."""
    data = GateData()
    rng = np.random.default_rng(seed)
    mols = []
    for i in rng.integers(0, len(data.family), size=n):
        tpl = data.family[i]
        pos = tpl["coords"] - tpl["coords"].mean(0)
        mols.append((pos + rng.uniform(0.0, 0.1) * rng.standard_normal(pos.shape),
                     np.asarray(tpl["types"])))
    return mols


def test_gate_scorer_matches_reed_tpu():
    mols = _jittered_chains()
    got = metrics.MoleculeMetrics().evaluate(mols)
    want = jmetrics.MoleculeMetrics().evaluate(mols)
    assert got == want
    assert 0.3 <= got["validity"] <= 0.9, got
