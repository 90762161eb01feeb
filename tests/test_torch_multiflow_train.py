"""reed_tpu_torch's MultiFlow trainer and sampler against reed_tpu's on the
CPU: a tiny MultiflowTrainConfig (c_s 32, c_z 16, 2 blocks, 3 chains of 12
residues with padded rows) whose every weight is drawn from a seeded
normal on reed_tpu's side and carried over by state_dict_from_flax, with
reed_tpu's draws handed over in its split order. multiflow_losses and every
gradient to 1e-4 of its max in f32 (with the batch-OT prior, the plain
prior, the auxiliary losses on, and the uniform interpolant); the bf16
gradient held as a whole against reed_tpu's bf16 gradient; one whole
train_step (Adam, EMA) against reed_tpu's jitted step; se3_sample for 5
steps with injected draws (trans and rotmats to 1e-4, tokens equal, with a
margin between the top two Gumbel-scaled scores asserted); then the
trainer's own draws, the synthetic batch and the refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion import se3 as jse3
from reed_tpu.train import multiflow as jmf
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.diffusion import se3
from reed_tpu_torch.encoders.multiflow_convert import state_dict_from_flax
from reed_tpu_torch.train import multiflow as mf
from test_torch_so3_se3 import corrupt_draws

torch.set_num_threads(1)
METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
TINY = dict(c_s=32, c_z=16, num_blocks=2, ipa_c_hidden=8, ipa_no_heads=2, ipa_no_qk_points=3,
            ipa_no_v_points=4, batch_size=3, max_len=12)
CASES = {
    "batch_ot": dict(),
    "plain_prior": dict(trans_batch_ot=False),
    "aux": dict(aux_loss_weight=1.0),
    "uniform_exp": dict(aatypes_interpolant="uniform", rots_train_schedule="exp"),
}


def _configs(aux_loss_weight=0.0, compute_dtype="float32", **interp):
    kw = dict(TINY, aux_loss_weight=aux_loss_weight, compute_dtype=compute_dtype)
    return (jmf.MultiflowTrainConfig(**kw, interpolant=jse3.SE3InterpolantConfig(**interp),
                                     mesh=JaxMesh(data=1)),
            mf.MultiflowTrainConfig(**kw, interpolant=se3.SE3InterpolantConfig(**interp)))


def _host_batch(cfg, seed=2):
    """Random-walk chains of 12 residues, the last with 3 padded residues."""
    b, n = cfg.batch_size, cfg.max_len
    batch = mf.synthetic_host_batch(np.random.default_rng(seed), b, n)
    mask = batch["res_mask"]
    mask[-1, -3:] = 0.0
    batch["trans_1"] = batch["trans_1"] * mask[..., None]
    if cfg.interpolant.trans_batch_ot:
        batch["trans_0"] = se3.batch_ot_trans_prior(np.random.default_rng(seed + 1),
                                                    batch["trans_1"], mask, 10.0)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k in ("aatypes_1", "res_idx") else jnp.float32)
            for k, v in batch.items()}


def _seeded(jcfg, seed=0, scale=0.1, bb_scale=0.02):
    """reed_tpu's FlowModel params with every leaf from a seeded normal (the
    backbone updates small), and a port state holding them."""
    jmodel = jmf.build_model(jcfg)
    jtrainer_batch = _jbatch(_host_batch(jcfg))
    noisy = jse3.corrupt_batch(jax.random.PRNGKey(0), jcfg.interpolant, jtrainer_batch)
    noisy["trans_sc"] = jnp.zeros_like(noisy["trans_t"])
    noisy["aatypes_sc"] = jax.nn.one_hot(noisy["aatypes_t"], 21)
    params = jmodel.init(jax.random.PRNGKey(0), noisy)["params"]
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(tree, [
        (rng.standard_normal(np.shape(x)) * (bb_scale if "bb_update" in
                                             jax.tree_util.keystr(p) else scale)
         ).astype(np.float32) for p, x in leaves])
    return jmodel, jax.tree.map(jnp.asarray, params)


def _port_state(tcfg, params):
    trainer = mf.MultiflowTrainer(tcfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.array, params)),
                                strict=True)
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(tcfg.optim, list(state.model.parameters()))
    return trainer, state


def _jax_total(jcfg, jmodel, jbatch, step_rng):
    def total(p):
        noisy = jse3.corrupt_batch(step_rng, jcfg.interpolant, jbatch)
        noisy["trans_sc"] = jnp.zeros_like(noisy["trans_t"])
        noisy["aatypes_sc"] = jax.nn.one_hot(noisy["aatypes_t"], 21)
        metrics = jmf.multiflow_losses(jcfg, noisy, jmodel.apply({"params": p}, noisy))
        return jax_combine_losses(metrics, 0, jcfg.curriculum)[0], metrics
    return total


def _key(jcfg, b, want_mixed_t=False):
    """A key whose step-0 t puts some rows above the auxiliary gate's 0.5 and
    some below (where asked)."""
    for k in range(50):
        key = jax.random.PRNGKey(k)
        t = np.asarray(jax.random.uniform(jax.random.split(jax.random.fold_in(key, 0), 4)[0],
                                          (b, 1))) * 0.98 + 0.01
        if not want_mixed_t or 0 < (t > 0.5).sum() < b:
            return key
    raise AssertionError("no key")


def _grads_and_metrics(tcfg, state, tbatch, draws):
    metrics = mf.make_loss_fn(tcfg)(state.model, tbatch, 0, draws=draws)
    loss, _ = combine_losses(metrics, 0, tcfg.curriculum)
    names, leaves = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return metrics, loss, {n: torch.zeros_like(p) if g is None else g
                           for n, g, p in zip(names, grads, leaves)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    jcfg, tcfg = _configs(**CASES[case])
    jmodel, params = _seeded(jcfg)
    trainer, state = _port_state(tcfg, params)
    batch = _host_batch(tcfg)
    jbatch = _jbatch(batch)
    b, n = batch["res_mask"].shape
    key = _key(jcfg, b, want_mixed_t=case == "aux")
    step_rng = jax.random.fold_in(key, 0)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        _jax_total(jcfg, jmodel, jbatch, step_rng), has_aux=True))(params)
    draws = corrupt_draws(step_rng, tcfg.interpolant, b, n,
                          with_trans_noise="trans_0" not in batch)
    metrics, loss, grads = _grads_and_metrics(tcfg, state, mf.batch_to_device(batch, "cpu"),
                                              draws)
    for k, v in list(jmetrics.items()) + [("loss", jloss)]:
        got = loss if k == "loss" else metrics[k]
        np.testing.assert_allclose(float(got.detach()), float(v), rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    if case == "aux":
        assert float(jmetrics["aux_loss"]) > 0
    want = state_dict_from_flax(jax.tree.map(np.array, jgrads))
    assert set(want) == set(grads)
    # IPA's linear_b bias shifts a head's logits of a row by one constant,
    # which the softmax ignores: its gradient is 0 and both frameworks read
    # rounding noise (~1e-10); a tensor's max is floored at 1e-4 of the
    # largest gradient for that reason
    floor = 1e-4 * max(w.abs().max().item() for w in want.values())
    for name, g in grads.items():
        err = (g - want[name]).abs().max().item()
        assert err <= GRAD_TOL * max(want[name].abs().max().item(), floor), (name, err)


def test_bf16_gradient_matches_jax():
    """compute_dtype bfloat16 (reed_tpu's `dtype`) with reed_tpu's draws.
    Each framework rounds to bf16 at its own points (PyTorch at every op;
    XLA on the CPU keeps f32 inside a fusion), so the bound is on the whole
    gradient: within 3 % of reed_tpu's bf16 gradient in L2 (0.43 % seen),
    and the port's within 3 % of its own f32 gradient (0.24 %; reed_tpu's
    bf16 0.38 %); metrics to 3e-2 of reed_tpu's bf16 ones; gradients f32.
    The port's gradient must sit at least 0.3x reed_tpu's bf16 distance
    from the f32 gradient, so that a port computing in f32 fails."""
    jcfg, tcfg = _configs(compute_dtype="bfloat16")
    jmodel, params = _seeded(jcfg)
    batch = _host_batch(tcfg)
    jbatch = _jbatch(batch)
    b, n = batch["res_mask"].shape
    step_rng = jax.random.fold_in(_key(jcfg, b), 0)
    total = _jax_total(jcfg, jmodel, jbatch, step_rng)
    _, jmetrics = total(params)
    jgrads = jax.jit(jax.grad(lambda p: total(p)[0]))(params)
    want = state_dict_from_flax(jax.tree.map(lambda x: np.array(x, np.float32), jgrads))
    draws = corrupt_draws(step_rng, tcfg.interpolant, b, n, with_trans_noise=False)
    tbatch = mf.batch_to_device(batch, "cpu")
    grads = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tcfg, compute_dtype=dtype)
        _, state = _port_state(cfg, params)
        metrics, _, grads[dtype] = _grads_and_metrics(cfg, state, tbatch, draws)
        if dtype == "bfloat16":
            for k, v in jmetrics.items():
                np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=3e-2,
                                           atol=3e-2, err_msg=k)
    names = sorted(want)
    assert all(grads["bfloat16"][k].dtype == torch.float32 for k in names)
    g, w, g32 = (torch.cat([d[k].flatten() for k in names])
                 for d in (grads["bfloat16"], want, grads["float32"]))
    assert (g - w).norm() <= 0.03 * w.norm(), ((g - w).norm() / w.norm()).item()
    assert (g - g32).norm() <= 0.03 * g32.norm()
    assert (g - g32).norm() >= 0.3 * (w - g32).norm()


def test_whole_step_matches_jax():
    """One MultiflowTrainer.train_step (loss, Adam, EMA) against reed_tpu's
    jitted step from the same state: metrics to 1e-5; the parameters to 2e-6
    where reed_tpu's first update moved them by more than 0.99 lr, to 2 lr
    elsewhere; the EMA to 1e-6."""
    jcfg, tcfg = _configs()
    jmodel, params = _seeded(jcfg)
    trainer, tstate = _port_state(tcfg, params)
    batch = _host_batch(tcfg)
    b, n = batch["res_mask"].shape
    key = _key(jcfg, b)
    jtrainer = jmf.MultiflowTrainer(jcfg)
    state = jtrainer.init_state()
    state = state.replace(params=params, ema_params=jax.tree.map(jnp.copy, params),
                          opt_state=jtrainer.optimizer.init(params))
    state, jmetrics = jtrainer.train_step(state, _jbatch(batch), key)
    draws = corrupt_draws(jax.random.fold_in(key, 0), tcfg.interpolant, b, n,
                          with_trans_noise=False)
    before = {k: p.detach().clone() for k, p in tstate.model.named_parameters()}
    tstate, tmetrics = trainer.train_step(tstate, mf.batch_to_device(batch, "cpu"), draws)
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


def sample_draws(key, b, n, steps, purity=True):
    """reed_tpu's draws inside se3_sample at `key`, in its split order."""
    r_init, r_scan = jax.random.split(key)
    r_tr, r_rot, _ = jax.random.split(r_init, 3)
    r_u, r_axis = jax.random.split(r_rot)
    step_keys = [jax.random.fold_in(r_scan, i) for i in range(steps - 1)]
    per_step = [jax.random.split(k, 3) for k in step_keys]

    def stack(fn, keys):
        return torch.from_numpy(np.stack([np.asarray(fn(r)) for r in keys]))

    prior = dict(trans_noise=torch.from_numpy(np.array(jax.random.normal(r_tr, (b, n, 3)))),
                 rot_u=torch.from_numpy(np.array(jax.random.uniform(r_u, (b, n)))),
                 rot_axis=torch.from_numpy(np.array(jax.random.normal(r_axis, (b, n, 3)))))
    if not purity:
        return se3.SE3SampleDraws(
            **prior, gumbel_u=stack(lambda r: jax.random.uniform(r, (b, n, 21)), step_keys))
    return se3.SE3SampleDraws(
        **prior, gumbel_u=stack(lambda r: jax.random.uniform(r[1], (b, n, 20)), per_step),
        unmask_u=stack(lambda r: jax.random.uniform(r[0], (b, n)), per_step),
        remask_u=stack(lambda r: jax.random.uniform(r[2], (b, n)), per_step))


@pytest.mark.parametrize("interpolant,seed", [("masking", 7), ("uniform", 8)])
def test_sampler_matches_jax(interpolant, seed):
    """se3_sample, 5 steps (purity unmasking, or the uniform interpolant's
    Euler step), the same draws: trans and rotmats to 1e-4 of their max,
    tokens equal. Each token sampled (from the masked positions with
    purity), and each final argmax, has its top score at least 1 % above
    the runner-up, so that no flip can come from rounding."""
    purity = interpolant == "masking"
    jcfg, tcfg = _configs(aatypes_interpolant=interpolant)
    jmodel, params = _seeded(jcfg, seed=3, scale=0.15)
    trainer, state = _port_state(tcfg, params)
    b, n, steps = 2, 12, 5
    key = jax.random.PRNGKey(seed)
    want = jse3.se3_sample(key, jcfg.interpolant,
                           lambda bt: jmodel.apply({"params": params}, bt), (b, n),
                           jnp.ones((b, n)), num_timesteps=steps)
    draws = sample_draws(key, b, n, steps, purity)
    calls = []

    def model_fn(batch):
        out = state.model(batch)
        calls.append((batch["aatypes_t"], out["pred_logits"]))
        return out

    got = se3.se3_sample(tcfg.interpolant, model_fn, (b, n), torch.ones(b, n),
                         num_timesteps=steps, draws=draws)
    for k in ("trans", "rotmats"):
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max() / np.abs(want[k]).max()
        assert err <= 1e-4, (k, err)
    assert np.array_equal(got["aatypes"].numpy(), np.asarray(want["aatypes"]))
    temp = tcfg.interpolant.aatypes_temp
    ts = se3.time_grid(tcfg.interpolant.min_t, steps)
    for i, (aat, logits) in enumerate(calls[:-1]):
        if purity:
            probs = torch.softmax(logits[..., :-1] / temp, -1)
            rows = aat == se3.MASK_TOKEN_INDEX
        else:   # the step's regularised probabilities
            cfg = tcfg.interpolant
            p = torch.softmax(logits / temp, -1)
            t, d_t, nn_ = ts[i], ts[i + 1] - ts[i], cfg.aatypes_noise
            p_curr = torch.gather(p, -1, aat[..., None])
            probs = se3._regularize_step_probs(
                d_t * (p * (1 + nn_ + nn_ * 20 * t) / (1 - t) + nn_ * p_curr), aat)
            rows = torch.ones_like(aat, dtype=torch.bool)
        score = (probs / (1e-10 - torch.log(draws.gumbel_u[i] + 1e-10))).sort(-1).values
        margin = (score[..., -1] - score[..., -2]) / score[..., -1]
        assert margin[rows].min() >= 1e-2, (i, margin[rows].min())
    final = calls[-1][1][..., :20 if purity else 21].sort(-1).values
    assert (final[..., -1] - final[..., -2]).min() >= 1e-2
    # the trainer's sampler: its own draws, finite, the schema
    out = trainer.sample(state.model, 2, 8, num_timesteps=3,
                         generator=torch.Generator().manual_seed(0))
    assert out["trans"].shape == (2, 8, 3) and torch.isfinite(out["rotmats"]).all()
    assert ((out["aatypes"] >= 0) & (out["aatypes"] < 20)).all()


def test_trainer_draws_learn_and_batch_schema():
    """Without handed-in draws the step draws from the trainer's generator
    (the same seed repeats the loss); a few steps on one synthetic batch
    lower the loss; the synthetic batch carries reed_tpu's keys, with the
    coupled prior when the interpolant asks for it."""
    _, tcfg = _configs()
    losses = []
    for _ in range(2):
        trainer = mf.MultiflowTrainer(tcfg, device="cpu")
        state = trainer.init_state()
        batch = trainer.synthetic_batch()
        losses.append([trainer.train_step(state, batch)[1]["loss"].item() for _ in range(10)])
    assert losses[0] == losses[1]
    assert np.mean(losses[0][-3:]) < np.mean(losses[0][:3])
    assert set(batch) == {"trans_1", "rotmats_1", "aatypes_1", "res_mask", "res_idx", "trans_0"}
    assert batch["aatypes_1"].dtype == torch.long and batch["trans_0"].shape == (3, 12, 3)
    _, plain = _configs(trans_batch_ot=False)
    assert "trans_0" not in mf.MultiflowTrainer(plain, device="cpu").synthetic_batch()
    assert dataclasses.asdict(mf.MultiflowTrainConfig()).keys() == \
        dataclasses.asdict(jmf.MultiflowTrainConfig()).keys()
    assert mf.MultiflowTrainConfig().c_s == 256 and mf.MultiflowTrainConfig().num_blocks == 6


def test_refusals():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mf.MultiflowTrainer(mf.MultiflowTrainConfig(compute_dtype="float16"), device="cpu")
    # data=2 and tensor=2 need two ranks (torchrun); the seq axis is not ported
    with pytest.raises(ValueError, match="torchrun"):
        mf.MultiflowTrainer(mf.MultiflowTrainConfig(mesh=mf.MeshConfig(data=2)), device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        mf.MultiflowTrainer(mf.MultiflowTrainConfig(mesh=mf.MeshConfig(tensor=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mf.MultiflowTrainer(mf.MultiflowTrainConfig(mesh=mf.MeshConfig(seq=2)), device="cpu")
