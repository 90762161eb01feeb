"""reed_tpu_torch's RDM (models/rdm_mlp.py, diffusion/rdm.py,
eval/rep_samplers.py, train/rdm.py) against reed_tpu's on the CPU, with a
tiny SimpleMLP (8 channels, width 32, bottleneck 24, time 16, 2 blocks, 13
class rows) whose every weight, both zero-initialised out_fc layers
included, is drawn from a seeded normal on the port's side and carried to
reed_tpu by reed_tpu's own convert_torch_rdm. reed_tpu's draws are handed
to the port (t and the noise of the loss from its split key; the
sampler's initial noise and each step's from its fold_in keys). The
forward, the training loss and rep_normalization agree to 1e-5 of their
size; the DDPM, DDIM (eta 0 and 1) and predictor-corrector samplers over
T = 12 and the rep samplers to 1e-4 of their max (every step feeds the
next); one whole train step (AdamW, cosine, EMA) to 1e-5 in the loss and
1e-6 of each parameter's size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import rdm as jrdm
from reed_tpu.encoders.rdm_convert import convert_torch_rdm
from reed_tpu.eval import rep_samplers as jrs
from reed_tpu.models.rdm_mlp import SimpleMLP as JaxMLP
from reed_tpu_torch.diffusion import rdm
from reed_tpu_torch.eval import rep_samplers
from reed_tpu_torch.models.rdm_mlp import SimpleMLP

torch.set_num_threads(1)
RTOL = 1e-5
SAMPLE_RTOL = 1e-4
TINY = dict(in_channels=8, time_embed_dim=16, model_channels=32, bottleneck_channels=24,
            out_channels=8, num_res_blocks=2, num_classes=12, context_channels=8)
T = 12


def _pair(std=0.2, seed=0, use_context=True):
    """(reed_tpu's SimpleMLP, its params, the port's SimpleMLP) with every
    port weight drawn from N(0, std^2), norms around 1."""
    model = SimpleMLP(**TINY, use_context=use_context)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if "layers.0.weight" in name or name == "out.0.weight" else 0.0
            p.copy_(base + std * torch.randn(p.shape, generator=g))
    params = convert_torch_rdm(model.state_dict())
    jmodel = JaxMLP(**TINY, use_context=use_context)
    return jmodel, jax.tree.map(jnp.asarray, params), model.eval()


def _inputs(b=6, seed=1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, TINY["in_channels"])).astype(np.float32),
            r.integers(0, 1000, size=b).astype(np.int32),
            r.integers(0, TINY["num_classes"] + 1, size=b).astype(np.int32))


def _close(name, ours, ref, rtol=RTOL):
    ours, ref = np.asarray(torch.as_tensor(ours).detach()), np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert np.isfinite(ours).all() and err <= rtol * scale, (name, err, scale)


@pytest.mark.parametrize("use_context", [True, False])
def test_simple_mlp_matches_reed_tpu(use_context):
    jmodel, params, model = _pair(use_context=use_context)
    x, t, n = _inputs()
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(n) if use_context else None)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(n).long() if use_context else None)
    _close("forward", got, want)


def test_names_and_init_follow_the_reference():
    model = SimpleMLP(**TINY).initialize_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for key in ("time_embed.0.weight", "time_embed.2.weight", "input_proj.weight",
                "res_blocks.1.in_layers.0.weight", "res_blocks.1.in_layers.2.weight",
                "res_blocks.1.emb_layers.1.weight", "res_blocks.1.context_layers.1.weight",
                "res_blocks.1.out_layers.0.weight", "res_blocks.1.out_layers.3.weight",
                "out.0.weight", "out.2.weight", "cond_stage_model.embedding.weight"):
        assert key in sd, key
    assert sd["cond_stage_model.embedding.weight"].shape == (TINY["num_classes"] + 1, 8)
    assert (sd["out.2.weight"] == 0).all() and (sd["res_blocks.0.out_layers.3.weight"] == 0).all()
    assert model.out[0].eps == 1e-6 and model.res_blocks[0].in_layers[0].eps == 1e-5
    w = sd["input_proj.weight"]
    assert abs(w.std().item() - 8 ** -0.5) < 0.15 * 8 ** -0.5


def _diffusions(parameterization="x0"):
    jmodel, params, model = _pair()
    cfg = dict(channels=8, timesteps=T, parameterization=parameterization)

    def jfn(x_t, t, n):
        return jmodel.apply({"params": params}, x_t, t, n)

    def fn(x_t, t, n):
        return model(x_t, t, n)

    return jrdm.RDMDiffusion(jrdm.RDMConfig(**cfg), jfn), rdm.RDMDiffusion(rdm.RDMConfig(**cfg),
                                                                             fn)


def test_schedule_tables_match_reed_tpu():
    jd, d = _diffusions()
    for name in ("betas", "alphas_cumprod", "sqrt_acp", "sqrt_one_minus_acp",
                 "posterior_variance", "posterior_log_var", "posterior_mean_c0",
                 "posterior_mean_ct"):
        _close(name, getattr(d, name), getattr(jd, name), 1e-6)


@pytest.mark.parametrize("parameterization", ["x0", "eps"])
def test_training_loss_matches_reed_tpu(parameterization):
    jd, d = _diffusions(parameterization)
    x, _, n = _inputs()
    rng = jax.random.PRNGKey(3)
    want = jd.training_loss(rng, jnp.asarray(x), jnp.asarray(n))
    rng_t, rng_n = jax.random.split(rng)
    t = np.array(jax.random.randint(rng_t, (x.shape[0],), 0, T))
    noise = np.asarray(jax.random.normal(rng_n, x.shape))
    with torch.no_grad():
        got = d.training_loss(torch.from_numpy(x), torch.from_numpy(n).long(),
                              t=torch.from_numpy(t), noise=noise)
    _close("loss", got, want)


def _sampler_keys(seed):
    rng_init, rng = jax.random.split(jax.random.PRNGKey(seed))
    return rng_init, rng


def test_p_sample_loop_matches_reed_tpu():
    jd, d = _diffusions()
    _, _, n = _inputs()
    shape = (n.shape[0], 8)
    want = jd.p_sample_loop(jax.random.PRNGKey(5), shape, jnp.asarray(n))
    rng_init, rng = _sampler_keys(5)
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(rng, T - 1 - i), shape))
              for i in range(T)]
    got = d.p_sample_loop(shape, torch.from_numpy(n).long(),
                          init=np.asarray(jax.random.normal(rng_init, shape)), noises=noises)
    _close("p_sample_loop", got, want, SAMPLE_RTOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_sample_matches_reed_tpu(eta):
    jd, d = _diffusions()
    _, _, n = _inputs()
    shape, steps = (n.shape[0], 8), 5
    want = jd.ddim_sample(jax.random.PRNGKey(6), shape, jnp.asarray(n), num_steps=steps,
                          eta=eta)
    rng_init, rng = _sampler_keys(6)
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(rng, i), shape))
              for i in range(steps)]
    got = d.ddim_sample(shape, torch.from_numpy(n).long(), num_steps=steps, eta=eta,
                        init=np.asarray(jax.random.normal(rng_init, shape)), noises=noises)
    _close("ddim", got, want, SAMPLE_RTOL)


def _pc_draws(seed, shape, n_corr):
    rng_init, rng = _sampler_keys(seed)
    corr = [[np.asarray(jax.random.normal(jax.random.fold_in(rng, i * 1000 + j), shape))
             for j in range(n_corr)] for i in range(T)]
    pred = [np.asarray(jax.random.normal(jax.random.fold_in(rng, 500_000 + i), shape))
            for i in range(T)]
    return dict(init=np.asarray(jax.random.normal(rng_init, shape)), corrector_noises=corr,
                predictor_noises=pred)


def test_pc_sample_matches_reed_tpu():
    jd, d = _diffusions()
    _, _, n = _inputs()
    shape = (n.shape[0], 8)
    want = jd.pc_sample(jax.random.PRNGKey(7), shape, jnp.asarray(n), n_corrector_steps=2,
                        snr=0.05, inv_temp=1.5)
    got = d.pc_sample(shape, torch.from_numpy(n).long(), n_corrector_steps=2, snr=0.05,
                      inv_temp=1.5, **_pc_draws(7, shape, 2))
    _close("pc", got, want, SAMPLE_RTOL)


def test_rep_normalization_matches_reed_tpu():
    x = np.random.default_rng(8).standard_normal((5, 16)).astype(np.float32) * 3 + 1
    got = rdm.rep_normalization(torch.from_numpy(x))
    _close("rep_normalization", got, jrdm.rep_normalization(jnp.asarray(x)))
    assert rep_samplers.rep_normalization is rdm.rep_normalization


def test_rep_samplers_match_reed_tpu():
    jd, d = _diffusions()
    nodes = np.array([3, 7, 12, 5])
    shape = (4, 8)
    jddim = jrs.initialize_rep_sampler("DDIMSampler", diffusion=jd, step_num=4)
    ddim = rep_samplers.initialize_rep_sampler("DDIMSampler", diffusion=d, step_num=4)
    assert (ddim.eta, rep_samplers.DDIMRepSampler(d).step_num) == (1.0, 250)
    rng_init, rng = _sampler_keys(9)
    got = ddim.sample(None, nodes, init=np.asarray(jax.random.normal(rng_init, shape)),
                      noises=[np.asarray(jax.random.normal(jax.random.fold_in(rng, i), shape))
                              for i in range(4)])
    _close("ddim sampler", got, jddim.sample(jax.random.PRNGKey(9), nodes), SAMPLE_RTOL)

    jpc = jrs.initialize_rep_sampler("PCSampler", diffusion=jd, inv_temp=2.0)
    pc = rep_samplers.initialize_rep_sampler("PCSampler", diffusion=d, inv_temp=2.0)
    got = pc.sample(None, nodes, **_pc_draws(10, shape, 1))
    _close("pc sampler", got, jpc.sample(jax.random.PRNGKey(10), nodes), SAMPLE_RTOL)

    # a numpy generator seeds the port's draws: same seed, same reps
    a = ddim.sample(np.random.default_rng(0), nodes)
    b = ddim.sample(np.random.default_rng(0), nodes)
    assert torch.equal(a, b) and a.shape == shape
    with pytest.raises(ValueError):
        rep_samplers.initialize_rep_sampler("nope")


def test_train_step_matches_reed_tpu():
    """One RDMTrainer step (AdamW wd 0.005, cosine, EMA) with reed_tpu's
    draws: the loss and every parameter and EMA entry after the step."""
    from reed_tpu.core.config import MeshConfig as JaxMesh
    from reed_tpu.core.config import OptimConfig as JaxOptim
    from reed_tpu.train import rdm as jtrain
    from reed_tpu_torch.core.config import OptimConfig
    from reed_tpu_torch.core.train_state import make_optimizer
    from reed_tpu_torch.train import rdm as train

    kw = dict(channels=8, model_channels=32, bottleneck_channels=24, num_res_blocks=2,
              time_embed_dim=16, max_nodes=12, batch_size=8)
    optim = dict(lr=1e-3, weight_decay=0.005, schedule="cosine", total_steps=10)
    cfg = train.RDMTrainConfig(**kw, optim=OptimConfig(**optim))
    jcfg = jtrain.RDMTrainConfig(**kw, optim=JaxOptim(**optim), mesh=JaxMesh(data=1))
    trainer = train.RDMTrainer(cfg, device="cpu")
    state = trainer.init_state()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    state.ema = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    state.opt = make_optimizer(cfg.optim, list(state.model.parameters()))
    jtrainer = jtrain.RDMTrainer(jcfg)
    jstate = jtrainer.init_state()
    params = jax.tree.map(jnp.asarray, convert_torch_rdm(state.model.state_dict()))
    jstate = jstate.replace(params=params, ema_params=jax.tree.map(jnp.copy, params),
                            opt_state=jtrainer.optimizer.init(params))
    r = np.random.default_rng(12)
    batch = {"rep": r.standard_normal((8, 8)).astype(np.float32),
             "num_atoms": r.integers(5, 12, size=8).astype(np.int32)}
    rng = jax.random.PRNGKey(13)
    jstate, jmetrics = jtrainer.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                           rng)
    rng_t, rng_n = jax.random.split(jax.random.fold_in(rng, 0))
    t = np.array(jax.random.randint(rng_t, (8,), 0, cfg.rdm.timesteps))
    noise = np.asarray(jax.random.normal(rng_n, (8, 8)))
    state, metrics = trainer.train_step(state, train.batch_to_device(batch, "cpu"),
                                        t=torch.from_numpy(t), noise=noise)
    _close("loss", metrics["denoising_loss"], jmetrics["denoising_loss"])
    want = convert_torch_rdm(state.model.state_dict())
    want_ema = convert_torch_rdm(state.ema)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.params):
        ours = want
        ours_ema = want_ema
        for k in path:
            ours, ours_ema = ours[k.key], ours_ema[k.key]
        _close(str(path), ours, leaf, 1e-6)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jstate.ema_params):
        ours_ema = want_ema
        for k in path:
            ours_ema = ours_ema[k.key]
        _close(f"ema {path}", ours_ema, leaf, 1e-6)


def test_trainer_learns_and_samples():
    """The trainer's own draws: the loss falls on a fixed batch, and the
    EMA model samples finite, standardised reps through DDIM."""
    from reed_tpu_torch.train import rdm as train

    cfg = train.RDMTrainConfig(channels=8, model_channels=32, bottleneck_channels=32,
                               num_res_blocks=1, time_embed_dim=16, max_nodes=12,
                               batch_size=16)
    trainer = train.RDMTrainer(cfg, device="cpu")
    state = trainer.init_state()
    batch = trainer.synthetic_batch()
    assert batch["rep"].shape == (16, 8) and int(batch["num_atoms"].max()) < 12
    losses = [float(trainer.train_step(state, batch)[1]["denoising_loss"]) for _ in range(30)]
    assert losses[-1] < losses[0]
    sampler = rep_samplers.DDIMRepSampler(trainer.diffusion(trainer.ema_model(state)),
                                          step_num=5)
    reps = sampler.sample(np.random.default_rng(0), np.array([5, 9]))
    assert reps.shape == (2, 8) and torch.isfinite(reps).all()
    assert torch.allclose(reps.mean(1), torch.zeros(2), atol=1e-5)
