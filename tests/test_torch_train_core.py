"""reed_tpu_torch's training core against reed_tpu's on the CPU: schedules,
combine_losses, EMA, and the optimizer (clip, Adam/AdamW, learning-rate
schedules, gradient accumulation) against the optax chain reed_tpu builds,
over a few steps on the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core import config as jc
from reed_tpu.core import ema as jema
from reed_tpu.core import schedules as js
from reed_tpu.core.train_state import make_optimizer as jax_make_optimizer
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu_torch.core import config as tc
from reed_tpu_torch.core import ema as tema
from reed_tpu_torch.core import schedules as ts
from reed_tpu_torch.core.train_state import global_norm, lr_schedule, make_optimizer
from reed_tpu_torch.core.trainer import combine_losses

torch.set_num_threads(1)

STEPS = [0, 1, 7, 50, 99, 100, 101, 250, 999, 1000, 5000]


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_decay_schedules_match_jax(kind):
    for step in STEPS:
        np.testing.assert_allclose(
            ts.repa_weight_decay(step, 1000, kind).numpy(),
            np.asarray(js.repa_weight_decay(step, 1000, kind)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            ts.diffusion_loss_decay(step, 10, 90, 2000, kind).numpy(),
            np.asarray(js.diffusion_loss_decay(step, 10, 90, 2000, kind)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine", "sigmoid", "loglinear",
                                  "cutoff"])
def test_time_weight_matches_jax(kind):
    t = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    np.testing.assert_allclose(
        ts.time_weight(torch.tensor(t), 0.5, kind, (0.2, 0.7)).numpy(),
        np.asarray(js.time_weight(t, 0.5, kind, (0.2, 0.7))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sigmoid"])
def test_encoder_weight_and_cosine_anneal_match_jax(kind):
    for step in STEPS:
        for focus in ("text", "image"):
            np.testing.assert_allclose(
                ts.encoder_weight(0.7, step, 1000, kind, focus).numpy(),
                np.asarray(js.encoder_weight(0.7, step, 1000, kind, focus)),
                rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.cosine_anneal(step, 1000, 1.0, 0.1).numpy(),
                                   np.asarray(js.cosine_anneal(step, 1000, 1.0, 0.1)),
                                   rtol=1e-6, atol=1e-7)


def test_combine_losses_matches_jax():
    cur = dict(proj_coeff=0.3, repa_decay="linear", repa_steps=500,
               diffusion_warmup_steps=100, diffusion_decay="cosine", max_steps=1000)
    metrics = {"denoising_loss": 1.7, "proj_loss": -0.4}
    for step in STEPS:
        ref, rsched = jax_combine_losses({k: jnp.float32(v) for k, v in metrics.items()},
                                         step, jc.CurriculumConfig(**cur))
        got, gsched = combine_losses({k: torch.tensor(v) for k, v in metrics.items()},
                                     step, tc.CurriculumConfig(**cur))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
        for k in rsched:
            np.testing.assert_allclose(gsched[k], np.asarray(rsched[k]),
                                       rtol=1e-6, atol=1e-7)


def test_default_curriculum_turns_denoising_off_at_step_0():
    """ProteinTrainConfig's default warms the denoising loss up over 50k
    steps from weight 0: a parity check must set diffusion_warmup_steps=0
    or it never sees the denoising gradient."""
    cur = tc.CurriculumConfig()
    assert cur.diffusion_warmup_steps == 50_000
    assert float(ts.diffusion_loss_decay(0, 0, cur.diffusion_warmup_steps,
                                         cur.max_steps)) == 0.0


@pytest.mark.parametrize("ema_dtype", [None, "bfloat16"])
def test_ema_matches_jax(ema_dtype):
    rng = np.random.default_rng(0)
    model = torch.nn.Linear(5, 3)
    p0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    ema = tema.ema_init(model, ema_dtype)
    ref = jema.ema_init({n: jnp.asarray(v) for n, v in p0.items()},
                        jnp.bfloat16 if ema_dtype else None)
    for _ in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.tensor(rng.standard_normal(p.shape).astype(np.float32)))
        tema.ema_update(ema, model, 0.9)
        ref = jema.ema_update(ref, {n: jnp.asarray(p.detach().numpy())
                                    for n, p in model.named_parameters()}, 0.9)
    tol = 1e-6 if ema_dtype is None else 1e-2
    for n in ema:
        assert ema[n].dtype == (torch.bfloat16 if ema_dtype else torch.float32)
        np.testing.assert_allclose(ema[n].float().numpy(),
                                   np.asarray(ref[n].astype(jnp.float32)),
                                   rtol=tol, atol=tol)


OPTIM_CASES = {
    "adam": dict(lr=1e-2),
    "adam_clipped": dict(lr=1e-2, grad_clip=0.5),    # every step clips
    "adam_not_clipped": dict(lr=1e-2, grad_clip=1e3),
    "adamw": dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0),
    "cosine": dict(lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=6),
    "onecycle": dict(lr=1e-2, schedule="onecycle", total_steps=10),
    "accum2": dict(lr=1e-2, grad_clip=0.5, accum_steps=2),
}


@pytest.mark.parametrize("name", sorted(OPTIM_CASES))
def test_optimizer_matches_optax(name):
    kw = OPTIM_CASES[name]
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    tx = jax_make_optimizer(jc.OptimConfig(**kw))
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = make_optimizer(tc.OptimConfig(**kw), tparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        opt.step([torch.tensor(x) for x in g])
        for tp, jp in zip(tparams, jparams):
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    if kw.get("accum_steps", 1) > 1:
        assert opt.count == len(grads) // kw["accum_steps"]


def test_lr_schedules_match_optax():
    import optax

    for cfg, ref in ((tc.OptimConfig(lr=0.1, schedule="cosine", warmup_steps=10,
                                     total_steps=100),
                      optax.warmup_cosine_decay_schedule(0.0, 0.1, 10, 100)),
                     (tc.OptimConfig(lr=0.1, schedule="onecycle", total_steps=100),
                      optax.linear_onecycle_schedule(100, 0.1))):
        sched = lr_schedule(cfg)
        for count in range(0, 120, 3):
            np.testing.assert_allclose(sched(count), float(ref(count)), rtol=1e-5,
                                       atol=1e-9)


def test_global_norm_and_unported_mu_dtype():
    """The global norm is optax's; mu_dtype, once unported, now keeps Adam's
    first moment in that dtype and the second in f32 (parity with optax in
    test_mu_dtype_matches_optax)."""
    import optax

    g = [torch.randn(3, 4), torch.randn(7)]
    np.testing.assert_allclose(float(global_norm(g)),
                               float(optax.global_norm([x.numpy() for x in g])), rtol=1e-6)
    opt = make_optimizer(tc.OptimConfig(mu_dtype="bfloat16"), [torch.zeros(2)])
    assert opt.mu[0].dtype == torch.bfloat16 and opt.nu[0].dtype == torch.float32
    opt.step([torch.ones(2)])
    assert opt.mu[0].dtype == torch.bfloat16 and opt.params[0].dtype == torch.float32


@pytest.mark.parametrize("name", ["adam", "adam_clipped", "adamw", "cosine", "accum2"])
def test_mu_dtype_matches_optax(name):
    """mu_dtype='bfloat16' over six steps against optax's Adam with
    mu_dtype=bf16, jitted as reed_tpu's train step runs it (eagerly, JAX
    would also round b1 * mu to bf16; under jit XLA keeps it in f32): the
    stored first moment to one bf16 ulp (the f32 sum it is rounded from may
    differ in its last bit), the parameters to 1e-6."""
    kw = dict(OPTIM_CASES[name], mu_dtype="bfloat16")
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** rng.integers(-3, 2)
              for s in shapes] for _ in range(6)]
    tx = jax_make_optimizer(jc.OptimConfig(**kw))
    update = jax.jit(tx.update)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    opt = make_optimizer(tc.OptimConfig(**kw), tparams)
    for g in grads:
        updates, state = update([jnp.asarray(x) for x in g], state, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        opt.step([torch.tensor(x) for x in g])
        for tp, jp in zip(tparams, jparams):
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
        jmu = [leaf for leaf in jax.tree.leaves(state) if leaf.dtype == jnp.bfloat16]
        assert len(jmu) == len(shapes)
        for m, jm in zip(opt.mu, jmu):
            assert m.dtype == torch.bfloat16
            want = torch.tensor(np.asarray(jm.astype(jnp.float32)))
            ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
            assert torch.all((m.float() - want).abs() <= ulp), (m, want)
