"""reed_tpu_torch's SemlaFlow trainer against reed_tpu's on the CPU: a
tiny SemlaGenerator (d_model 32, 3 layers, batch 3 x 10 atoms) with the
same seeded-normal weights and the same host batch. One f32 train step:
metrics to 1e-5 and every gradient to 5e-4 of its max against reed_tpu's
jax.grad of the same loss, with the self-conditioning coin injected both
ways (reed_tpu's coin found by searching its key); the parameters and the
EMA after one whole step. Then `generate` for 5 steps with reed_tpu's
integrator draws injected, the example batch bitwise, the losses' mask
strategies, and the trainer's refusals; mixed precision's loss and
gradients against reed_tpu's bf16 (bound stated in its test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.molecule_fm import IntegratorConfig as JaxIntegrator
from reed_tpu.diffusion.molecule_fm import MoleculeInterpolantConfig as JaxInterp
from reed_tpu.diffusion.molecule_fm import MoleculePriorConfig as JaxPrior
from reed_tpu.train.molecule_semla import SemlaTrainConfig as JaxConfig
from reed_tpu.train.molecule_semla import SemlaTrainer as JaxTrainer
from reed_tpu.train.molecule_semla import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core.config import CurriculumConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.diffusion.molecule_fm import (IntegratorConfig,
                                                  MoleculeInterpolantConfig,
                                                  MoleculePriorConfig)
from reed_tpu_torch.encoders.semla_convert import state_dict_from_flax
from reed_tpu_torch.train import molecule_semla as ms
from torch_parity import semla_inputs, semla_random_params

torch.set_num_threads(1)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
TINY = dict(vocab_size=6, n_bond_types=5, n_charge_types=7, max_atoms=12, d_model=32,
            d_message=16, n_layers=3, n_coord_sets=4, d_message_hidden=16, d_edge=8,
            n_attn_heads=4, size_emb=8, d_rep=16, rep_alignment=True, align_depth=(1,),
            batch_size=3)
CASES = {
    "sc_none": (True, dict()),
    "no_sc_none": (False, dict()),
    "sc_adaLN_mask_losses": (True, dict(cond_type="adaLN", type_strategy="mse",
                                        bond_strategy="mask",
                                        integrator=dict(bond_mask_index=2))),
    "no_sc_cross_attn": (False, dict(cond_type="cross_attn", type_strategy="mask",
                                     integrator=dict(type_mask_index=1))),
}


def _configs(**kw):
    integ = kw.pop("integrator", {})
    jcfg = JaxConfig(**TINY, **kw, integrator=JaxIntegrator(cat_noise_level=1.0, **integ),
                     interpolant=JaxInterp(prior=JaxPrior(vocab_size=6), coord_noise_std=0.2),
                     mesh=JaxMesh(data=1),
                     curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0))
    tcfg = ms.SemlaTrainConfig(**TINY, **kw,
                               integrator=IntegratorConfig(cat_noise_level=1.0, **integ),
                               interpolant=MoleculeInterpolantConfig(
                                   prior=MoleculePriorConfig(vocab_size=6),
                                   coord_noise_std=0.2),
                               curriculum=CurriculumConfig(proj_coeff=0.2,
                                                           diffusion_warmup_steps=0))
    return jcfg, tcfg


def _params(jtrainer, cfg):
    kw = dict(vocab_size=cfg.vocab_size, n_edge_types=cfg.n_bond_types, d_edge=cfg.d_edge,
              self_cond=cfg.self_cond, d_rep=cfg.d_rep)
    return semla_random_params(jtrainer.model, semla_inputs(kw, batch=2, n=8), std=0.1)


def _key_with_coin(use_sc):
    """A key whose step-0 self-conditioning coin (reed_tpu:
    uniform(fold_in(fold_in(key, step), 1)) > 0.5) comes out `use_sc`."""
    for k in range(100):
        key = jax.random.PRNGKey(k)
        coin = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, 0), 1), ())
        if bool(coin > 0.5) == use_sc:
            return key
    raise AssertionError("no key")


def _port_state(tcfg, params):
    trainer = ms.SemlaTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(params))
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(tcfg.optim, list(state.model.parameters()))
    return trainer, state


def _grad_scale(name, want, gmax):
    """What a gradient's error is measured against: its own max, except for
    the bias of a layer's attention logits without an edge output: the
    softmax over j is shift invariant, so that gradient is 0 up to rounding
    in both frameworks (~1e-9), and the model's largest gradient is taken."""
    own = want.abs().max().item()
    if name.endswith("message_ff.message_mlp.2.bias") and own <= 1e-6 * gmax:
        return gmax
    return own


def _jax_case(case):
    use_sc, kw = CASES[case]
    jcfg, tcfg = _configs(**kw)
    jtrainer = JaxTrainer(jcfg)
    params = _params(jtrainer, jcfg)
    batch = ms.example_batch(tcfg, 3, max_n=10, seed=1)
    return use_sc, jcfg, tcfg, jtrainer, params, batch, _key_with_coin(use_sc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    """Metrics (the combined loss included) to 1e-5 and every gradient to
    5e-4 of its max, against jax.value_and_grad of reed_tpu's loss at step
    0 with the same self-conditioning coin."""
    use_sc, jcfg, tcfg, jtrainer, params, batch, key = _jax_case(case)
    jbatch = jax.tree.map(jnp.asarray, batch)
    curriculum = JaxCurriculum(**{**jcfg.curriculum.__dict__,
                                  "proj_coeff": jcfg.repa_loss_weight})
    loss_fn = jax_make_loss_fn(jtrainer.model, jcfg)
    step_rng = jax.random.fold_in(key, 0)

    def total(p):
        metrics = loss_fn(p, jbatch, step_rng, 0)
        loss, _ = jax_combine_losses(metrics, 0, curriculum)
        return loss, metrics

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, params))

    trainer, tstate = _port_state(tcfg, params)
    metrics = ms.make_loss_fn(tcfg)(tstate.model, ms.batch_to_device(batch, "cpu"), 0,
                                    use_sc=use_sc)
    loss, _ = combine_losses(metrics, 0, trainer.curriculum)
    assert set(metrics) == set(jmetrics)
    for k, v in list(jmetrics.items()) + [("loss", jloss)]:
        got = loss if k == "loss" else metrics[k]
        np.testing.assert_allclose(float(got.detach()), float(v), rtol=METRIC_TOL,
                                   atol=METRIC_TOL,
                                   err_msg=k)
    names, leaves = zip(*tstate.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = state_dict_from_flax(jax.tree.map(np.array, jgrads))
    assert set(want) == set(names)
    gmax = max(w.abs().max().item() for w in want.values())
    for name, g, p in zip(names, grads, leaves):
        g = torch.zeros_like(p) if g is None else g
        scale = _grad_scale(name, want[name], gmax)
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _grads(tcfg, params, batch, use_sc):
    trainer, tstate = _port_state(tcfg, params)
    metrics = ms.make_loss_fn(tcfg)(tstate.model, ms.batch_to_device(batch, "cpu"), 0,
                                    use_sc=use_sc)
    loss, _ = combine_losses(metrics, 0, trainer.curriculum)
    names, leaves = zip(*tstate.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return metrics, {n: torch.zeros_like(p) if g is None else g
                     for n, g, p in zip(names, grads, leaves)}


@pytest.mark.parametrize("case", ["sc_none", "no_sc_cross_attn"])
def test_bf16_loss_and_gradients_match_jax(case):
    """Mixed precision (bf16 features, f32 coordinates) against reed_tpu's
    at step 0 with the same coin. Each framework rounds to bf16 at its own
    points (PyTorch at every op; XLA on the CPU keeps f32 inside a fusion),
    and on this tiny model bf16 moves single tensors' gradients by up to
    ~20 % of their size in either framework, so the bound is on the whole
    gradient (every tensor but the shift-invariant logit biases, as in the
    f32 test): within 10 % of reed_tpu's bf16 gradient in L2 (1.0 % and 6.0 %
    seen), and the port's within 10 % of the f32 gradient (1.2 % and 4.8 %;
    reed_tpu's 1.7 % and 2.1 %); each tensor within 50 % of reed_tpu's
    (38 % at most seen); metrics to 2e-2. Gradients stay f32. The port's
    gradient must sit at least 0.3x reed_tpu's bf16 distance from the f32
    gradient, so that a port computing in f32 fails."""
    use_sc, jcfg, tcfg, jtrainer, params, batch, key = _jax_case(case)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    jtrainer = JaxTrainer(jcfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    curriculum = JaxCurriculum(**{**jcfg.curriculum.__dict__,
                                  "proj_coeff": jcfg.repa_loss_weight})
    loss_fn = jax_make_loss_fn(jtrainer.model, jcfg)

    def total(p):
        metrics = loss_fn(p, jbatch, jax.random.fold_in(key, 0), 0)
        return jax_combine_losses(metrics, 0, curriculum)[0], metrics

    _, jmetrics = total(jax.tree.map(jnp.asarray, params))
    jgrads = jax.jit(jax.grad(lambda p: total(p)[0]))(jax.tree.map(jnp.asarray, params))
    want = state_dict_from_flax(jax.tree.map(lambda x: np.array(x, np.float32), jgrads))
    metrics, grads = _grads(dataclasses.replace(tcfg, compute_dtype="bfloat16"), params,
                            batch, use_sc)
    _, grads32 = _grads(tcfg, params, batch, use_sc)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=2e-2,
                                   atol=2e-2, err_msg=k)
    keep = [n for n in grads if not n.endswith("message_ff.message_mlp.2.bias")]
    assert all(grads[n].dtype == torch.float32 for n in grads)
    g, w, g32 = (torch.cat([d[n].flatten() for n in keep]) for d in (grads, want, grads32))
    assert (g - w).norm() <= 0.1 * w.norm()
    assert (g - g32).norm() <= 0.1 * g32.norm()
    # and it is a bf16 gradient: an f32 step in its place sits 0 from g32
    assert (g - g32).norm() >= 0.3 * (w - g32).norm()
    for n in keep:
        assert (grads[n] - want[n]).norm() <= 0.5 * want[n].norm(), n


def test_whole_step_matches_jax():
    """One whole SemlaTrainer.train_step (loss, Adam with the global-norm
    clip, EMA) against reed_tpu's jitted train step from the same state:
    its metrics to 1e-5; the parameters to 2e-6 where reed_tpu's first
    update, lr * g / (|g| + eps), moved them by more than 0.99 lr (|g| above
    ~1e-6, where the update is insensitive to the gradient's last digits)
    and to 2 * lr elsewhere; the EMA to 1e-6."""
    use_sc, jcfg, tcfg, jtrainer, params, batch, key = _jax_case("sc_adaLN_mask_losses")
    jparams = jax.tree.map(jnp.asarray, params)
    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    state, jmetrics = jtrainer.train_step(state, jax.tree.map(jnp.asarray, batch), key)

    trainer, tstate = _port_state(tcfg, params)
    before = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    tstate, tmetrics = trainer.train_step(tstate, ms.batch_to_device(batch, "cpu"),
                                          use_sc=use_sc)
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


def test_self_conditioning_coin_from_generator():
    """Without an injected coin the trainer's CPU generator decides, about
    half of the steps, the same way for the same seed."""
    _, tcfg = _configs()
    coins = []
    for seed in (0, 0):
        trainer = ms.SemlaTrainer(dataclasses.replace(tcfg, seed=seed), device="cpu")
        loss_fn = ms.make_loss_fn(tcfg)
        seen = []
        real = ms._apply

        def counting(*a, **k):
            seen.append(1)
            return real(*a, **k)

        ms._apply, model = counting, ms.build_model(tcfg)
        try:
            batch = ms.batch_to_device(ms.example_batch(tcfg, 2, 6), "cpu")
            out = []
            for _ in range(16):
                seen.clear()
                loss_fn(model, batch, 0, generator=trainer.generator)
                out.append(len(seen) == 2)
        finally:
            ms._apply = real
        coins.append(out)
    assert coins[0] == coins[1] and 3 <= sum(coins[0]) <= 13


GENERATE = {
    "linear_last": dict(),
    "log_extra": dict(sampling_strategy="log", final_protocol="extra"),
    "zero_cond_temp": dict(zero_cond=True, pred_temp=0.5),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_matches_jax(case):
    kw = GENERATE[case]
    jcfg, tcfg = _configs(cond_type="adaLN")
    jcfg = dataclasses.replace(jcfg, integrator=dataclasses.replace(jcfg.integrator, steps=5))
    tcfg = dataclasses.replace(tcfg, integrator=dataclasses.replace(tcfg.integrator, steps=5))
    jtrainer = JaxTrainer(jcfg)
    params = _params(jtrainer, jcfg)
    mask = np.ones((2, 9), np.float32)
    mask[1, 6:] = 0
    prior = jtrainer.sample_prior(np.random.default_rng(2), mask)
    rep = np.random.default_rng(3).standard_normal((2, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jtrainer.generate(jax.tree.map(jnp.asarray, params), key, prior,
                            rep=jnp.asarray(rep), **kw)
    b, n = mask.shape
    draws = []
    for i in range(5):
        _, r_type, r_bond = jax.random.split(jax.random.fold_in(key, i), 3)
        draws.append([np.array(jax.random.uniform(r_type, (b, n, 6))),
                      np.array(jax.random.uniform(r_bond, (b, n, n, 5)))])

    trainer, state = _port_state(tcfg, params)
    tprior = {k: torch.from_numpy(np.array(v)) for k, v in prior.items()}
    out = trainer.generate(state.model, tprior, rep=torch.from_numpy(rep), draws=draws, **kw)
    for k in ("coords", "atomics", "bonds", "charges", "mask"):
        ours, want = out[k].numpy(), np.asarray(ref[k])
        assert ours.shape == want.shape, k
        np.testing.assert_allclose(ours, want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=k)
    np.testing.assert_array_equal(out["atomics"].numpy().argmax(-1),
                                  np.asarray(ref["atomics"]).argmax(-1))
    np.testing.assert_array_equal(out["bonds"].numpy().argmax(-1),
                                  np.asarray(ref["bonds"]).argmax(-1))


def test_example_batch_bitwise():
    jcfg, tcfg = _configs()
    ref = JaxTrainer(jcfg).example_batch(4, 10, seed=3)
    ours = ms.example_batch(tcfg, 4, 10, seed=3)
    assert ref.keys() == ours.keys()
    for k in ref:
        for a, b in (zip(ref[k].values(), ours[k].values()) if isinstance(ref[k], dict)
                     else [(ref[k], ours[k])]):
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_refusals():
    _, tcfg = _configs()
    # the alternative generators are ported: the trainer builds them, and an
    # architecture reed_tpu does not have is refused
    for arch in ("egnn", "eqgat"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, arch=arch), device="cpu").init_state()
    with pytest.raises(ValueError, match="semla, egnn or eqgat"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, arch="gvp"), device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, compute_dtype="float16"), device="cpu")
    # data=2 and fsdp=2 need two ranks (torchrun; tests/test_torch_fsdp.py);
    # the seq axis runs on SiT only
    with pytest.raises(ValueError, match="torchrun"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, mesh=ms.MeshConfig(data=2)), device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, mesh=ms.MeshConfig(fsdp=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8b"):
        ms.SemlaTrainer(dataclasses.replace(tcfg, mesh=ms.MeshConfig(seq=2)), device="cpu")


def test_loss_falls_in_a_short_run():
    _, tcfg = _configs(cond_type="adaLN")
    tcfg = dataclasses.replace(tcfg, optim=dataclasses.replace(tcfg.optim, lr=3e-3))
    trainer = ms.SemlaTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    batch = ms.batch_to_device(ms.example_batch(tcfg, 3, 8, seed=0), "cpu")
    losses = []
    for _ in range(12):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0], losses
