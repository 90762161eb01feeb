"""reed_tpu_torch's EDM-path molecule trainer against reed_tpu's on the CPU:
a tiny MoleculeEDMConfig (hidden 32, 2 blocks, 9 atoms, rep 16, batch 3)
whose every weight is drawn from a seeded normal on the port's side and
carried to reed_tpu by its converter, with reed_tpu's draws handed over
(t, eps, the rotation quaternions, the dequantisation noise, and the
rep-dropout mask read off the rep reed_tpu's EGNN receives). One step's
metrics to 1e-5 and every gradient to 5e-4 of its max, for EDM (with and
without rotation and rep) and for fm; one whole train_step (Adam, EMA)
against reed_tpu's jitted step; then the trainer's own draws, the
synthetic batch schema and sampling from the EMA."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion import edm as jedm
from reed_tpu.diffusion import efm as jefm
from reed_tpu.encoders.edm_convert import convert_torch_egnn_dynamics
from reed_tpu.train import molecule_edm as jme
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.encoders.edm_convert import state_dict_from_flax
from reed_tpu_torch.train import molecule_edm as me
from torch_parity import edm_inputs

torch.set_num_threads(1)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
TINY = dict(hidden_nf=32, n_layers=2, inv_sublayers=2, max_nodes=9, rep_nf=16, batch_size=3)
CASES = {
    "edm": dict(),
    "edm_rotation": dict(augment_rotation=True),
    "edm_no_rep": dict(rep_nf=None),
    "fm": dict(probabilistic_model="fm"),
}


def _configs(**kw):
    kw = dict(TINY, **kw)
    return (jme.MoleculeEDMConfig(**kw, mesh=JaxMesh(data=1)),
            me.MoleculeEDMConfig(**kw))


def _batch(rep_nf, seed=2):
    inputs = edm_inputs(rep_nf=rep_nf or 0)
    mask = inputs["node_mask"]
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 5, size=mask.shape[:2])
    batch = {"positions": inputs["xh"][..., :3] + 0.5 * mask,   # off its centre of mass
             "one_hot": np.eye(5, dtype=np.float32)[types] * mask,
             "charges": rng.integers(1, 10, size=mask.shape).astype(np.float32) * mask,
             "node_mask": mask, "edge_mask": inputs["edge_mask"]}
    if rep_nf:
        batch["rep"] = inputs["rep"]
    return batch


def _port_state(tcfg, seed=0):
    """A port state whose every parameter is seeded-normal, and its reed_tpu
    params."""
    trainer = me.MoleculeEDMTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state.model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(tcfg.optim, list(state.model.parameters()))
    params = convert_torch_egnn_dynamics(
        {k: v.numpy() for k, v in state.model.state_dict().items()})
    return trainer, state, params


def _draws(jcfg, jbatch, params, jmodel, step_rng):
    """reed_tpu's draws inside make_loss_fn at `step_rng`, for the port."""
    rng_loss, rng_rot = jax.random.split(step_rng)
    b, n = jbatch["positions"].shape[:2]
    draws = {}
    if jcfg.augment_rotation:
        draws["quat"] = jax.random.normal(rng_rot, (b, 4))
    if jcfg.probabilistic_model == "fm":
        r_deq, r_t, r_eps, _ = jax.random.split(rng_loss, 4)
        r1, r2 = jax.random.split(r_deq)
        cnf = jefm.EquivariantCNF(jme._efm_cfg(jcfg), None)
        draws["deq_noise"] = (jax.random.uniform(r1, (b, n, 5)),
                              jax.random.uniform(r2, (b, n, 1)))
        draws["t"] = jax.random.uniform(r_t, (b,))
        draws["eps"] = cnf.sample_combined_noise(r_eps, b, n, jbatch["node_mask"])
    else:
        rng_t, rng_eps, _, _, _ = jax.random.split(rng_loss, 5)
        wrapper = jedm.EnVariationalDiffusion(
            dataclasses.replace(jcfg.edm, in_node_nf=6), None)
        draws["t_int"] = jax.random.randint(rng_t, (b, 1), 0, jcfg.edm.timesteps + 1)
        draws["eps"] = wrapper.sample_combined_noise(rng_eps, b, n, jbatch["node_mask"])
    out = {k: (tuple(torch.from_numpy(np.array(x)) for x in v) if isinstance(v, tuple)
               else torch.from_numpy(np.array(v))) for k, v in draws.items()}
    if jcfg.rep_nf is not None:
        # the dropout mask: rows of the rep reed_tpu's EGNN receives that are
        # the fake latent
        seen = {}

        def capture(next_fun, args, kwargs, context):
            if type(context.module).__name__ == "EGNN":
                seen["rep"] = np.asarray(kwargs["rep"])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(capture):
            jme.make_loss_fn(jmodel, jcfg)(params, jbatch, step_rng, 0)
        out["drop"] = torch.from_numpy(
            np.all(seen["rep"] == np.asarray(params["fake_latent"]), axis=-1))
    return out


def _key_with_drop(jcfg, jbatch, params, jmodel):
    """A key whose step-0 draws drop one row's rep and keep another's."""
    for k in range(60):
        key = jax.random.PRNGKey(k)
        draws = _draws(jcfg, jbatch, params, jmodel, jax.random.fold_in(key, 0))
        if "drop" not in draws or 0 < int(draws["drop"].sum()) < len(draws["drop"]):
            return key, draws
    raise AssertionError("no key")


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    jcfg, tcfg = _configs(**CASES[case])
    jtrainer = jme.MoleculeEDMTrainer(jcfg)
    trainer, tstate, params = _port_state(tcfg)
    batch = _batch(tcfg.rep_nf)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, params)
    key, draws = _key_with_drop(jcfg, jbatch, jparams, jtrainer.model)
    loss_fn = jme.make_loss_fn(jtrainer.model, jcfg)
    step_rng = jax.random.fold_in(key, 0)

    def total(p):
        metrics = loss_fn(p, jbatch, step_rng, 0)
        return jax_combine_losses(metrics, 0, jcfg.curriculum)[0], metrics

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    tbatch = me.batch_to_device(batch, "cpu")
    metrics = me.make_loss_fn(tcfg)(tstate.model, tbatch, 0, **draws)
    loss, _ = combine_losses(metrics, 0, tcfg.curriculum)
    for k, v in list(jmetrics.items()) + [("loss", jloss)]:
        got = loss if k == "loss" else metrics[k]
        np.testing.assert_allclose(float(got.detach()), float(v), rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    names, leaves = zip(*tstate.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = state_dict_from_flax(jax.tree.map(np.array, jgrads))
    assert set(want) == set(names)
    for name, g, p in zip(names, grads, leaves):
        g = torch.zeros_like(p) if g is None else g
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_TOL * want[name].abs().max().item(), (name, err)


@pytest.mark.parametrize("case", ["edm", "fm"])
def test_bf16_loss_and_gradients_match_jax(case):
    """compute_dtype bfloat16 (reed_tpu's `dtype`) with reed_tpu's draws.
    Each framework rounds to bf16 at its own points (PyTorch at every op;
    XLA on the CPU keeps f32 inside a fusion), so the bound is on the whole
    gradient: within 3 % of reed_tpu's bf16 gradient in L2 (0.55-0.60 %
    seen) and the port's within 3 % of the f32 gradient (the port's f32
    loss on the same draws; 0.66-0.81 %, reed_tpu's 0.50-0.51 %); each
    tensor within 50 % of reed_tpu's (at most 20 % seen, in small
    tensors); metrics to 2e-2; gradients f32. The port's gradient must sit
    at least 0.3x reed_tpu's bf16 distance from the f32 gradient, so that a
    port computing in f32 fails."""
    jcfg, tcfg = _configs(**CASES[case])
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jtrainer = jme.MoleculeEDMTrainer(jcfg)
    trainer, tstate, params = _port_state(tcfg)
    batch = _batch(tcfg.rep_nf)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, params)
    key, draws = _key_with_drop(jcfg, jbatch, jparams, jtrainer.model)
    loss_fn = jme.make_loss_fn(jtrainer.model, jcfg)
    step_rng = jax.random.fold_in(key, 0)

    def total(p):
        metrics = loss_fn(p, jbatch, step_rng, 0)
        return jax_combine_losses(metrics, 0, jcfg.curriculum)[0], metrics

    _, jmetrics = total(jparams)
    jgrads = jax.jit(jax.grad(lambda p: total(p)[0]))(jparams)
    want = state_dict_from_flax(jax.tree.map(lambda x: np.array(x, np.float32), jgrads))
    tbatch = me.batch_to_device(batch, "cpu")
    names, leaves = zip(*tstate.model.named_parameters())
    grads = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        model = me.build_dynamics(cfg)
        model.load_state_dict(tstate.model.state_dict())
        metrics = me.make_loss_fn(cfg)(model, tbatch, 0, **draws)
        loss, _ = combine_losses(metrics, 0, cfg.curriculum)
        gs = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        grads[dtype] = {n: torch.zeros_like(p) if g is None else g
                        for n, g, p in zip(names, gs, leaves)}
        if dtype == "bfloat16":
            for k, v in jmetrics.items():
                np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                           rtol=2e-2, atol=2e-2, err_msg=k)
    assert all(g.dtype == torch.float32 for g in grads["bfloat16"].values())
    g, w, g32 = (torch.cat([d[n].flatten() for n in names])
                 for d in (grads["bfloat16"], want, grads["float32"]))
    assert (g - w).norm() <= 0.03 * w.norm() and (g - g32).norm() <= 0.03 * g32.norm()
    # and it is a bf16 gradient: an f32 step in its place sits 0 from g32
    assert (g - g32).norm() >= 0.3 * (w - g32).norm()
    for n in names:
        assert (grads["bfloat16"][n] - want[n]).norm() <= 0.5 * want[n].norm(), n


def test_whole_step_matches_jax():
    """One MoleculeEDMTrainer.train_step (loss, Adam, EMA) against reed_tpu's
    jitted step from the same state: metrics to 1e-5; the parameters to
    2e-6 where reed_tpu's first update lr * g / (|g| + eps) moved them by
    more than 0.99 lr, to 2 lr elsewhere; the EMA to 1e-6."""
    jcfg, tcfg = _configs(augment_rotation=True)
    jtrainer = jme.MoleculeEDMTrainer(jcfg)
    trainer, tstate, params = _port_state(tcfg)
    batch = _batch(tcfg.rep_nf)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, params)
    key, draws = _key_with_drop(jcfg, jbatch, jparams, jtrainer.model)
    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    state, jmetrics = jtrainer.train_step(state, jbatch, key)

    before = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    tstate, tmetrics = trainer.train_step(tstate, me.batch_to_device(batch, "cpu"), **draws)
    assert tstate.step == 1 and set(tmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    lr = tcfg.optim.lr
    after = state_dict_from_flax(jax.tree.map(np.array, state.params))
    ema_after = state_dict_from_flax(jax.tree.map(np.array, state.ema_params))
    for name, p in tstate.model.named_parameters():
        moved = (after[name] - before[name]).abs() > 0.99 * lr
        diff = (p.detach() - after[name]).abs()
        if moved.any():
            assert diff[moved].max().item() <= 2e-6, name
        assert diff.max().item() <= 2 * lr, name
        np.testing.assert_allclose(tstate.ema[name].numpy(), ema_after[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_random_rotation_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 5, 3)).astype(np.float32)
    q = jax.random.normal(jax.random.PRNGKey(1), (4, 4))
    want = np.asarray(jme.random_rotation(jax.random.PRNGKey(1), jnp.asarray(x)))
    got = me.random_rotation(torch.from_numpy(x), q=torch.from_numpy(np.array(q))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a rotation: lengths kept
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.linalg.norm(x, axis=-1),
                               rtol=1e-5)


def test_trainer_draws_learns_and_samples():
    """Without handed-in draws the step draws from the trainer's generator
    (the same seed repeats the loss); a few steps on one synthetic batch
    lower the loss; the EMA model samples finite, zero-CoM molecules of the
    batch's sizes, with CFG too."""
    _, tcfg = _configs(edm=me.EDMConfig(timesteps=8))
    losses = []
    for _ in range(2):
        trainer = me.MoleculeEDMTrainer(tcfg, device="cpu")
        state = trainer.init_state()
        batch = trainer.synthetic_batch()
        run = [trainer.train_step(state, batch)[1]["loss"].item() for _ in range(12)]
        losses.append(run)
    assert losses[0] == losses[1]
    assert np.mean(losses[0][-3:]) < np.mean(losses[0][:3])
    assert set(batch) == {"positions", "one_hot", "charges", "node_mask", "edge_mask", "rep"}
    mask = batch["node_mask"]
    assert torch.equal(batch["edge_mask"].sum((1, 2, 3)),
                       mask.sum((1, 2)) * (mask.sum((1, 2)) - 1))
    model = trainer.ema_model(state)
    for scale in (None, 2.0):
        x, cat, charge = trainer.sample(model, mask, batch["edge_mask"], rep=batch["rep"],
                                        cfg_scale=scale,
                                        generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(x).all() and torch.isfinite(charge).all()
        assert (x * mask).sum(1).abs().max() < 1e-4
        assert torch.equal(cat.sum(-1, keepdim=True), mask)


def test_refusals():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        me.MoleculeEDMTrainer(me.MoleculeEDMConfig(compute_dtype="float16"), device="cpu")
    # data=2 needs two ranks (torchrun); the tensor axis is not ported
    with pytest.raises(ValueError, match="torchrun"):
        me.MoleculeEDMTrainer(me.MoleculeEDMConfig(mesh=me.MeshConfig(data=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        me.MoleculeEDMTrainer(me.MoleculeEDMConfig(mesh=me.MeshConfig(tensor=2)), device="cpu")
    with pytest.raises(ValueError):
        me.MoleculeEDMTrainer(me.MoleculeEDMConfig(probabilistic_model="flow"), device="cpu")
