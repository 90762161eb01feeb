"""reed_tpu_torch's image train step against reed_tpu's ImageTrainer on the
CPU: one full step of a tiny SiT (hidden 64, depth 2, 4 heads, 8x8x4
latents, two projectors at split depths 1 and 2, batch 4, denoising loss
on from step 0) with the same seeded-normal weights (adaLN and final layer
nonzero), the same batch and reed_tpu's t, eps and label drops handed
over, in f32 and in bf16. Then the EMA's gating, the CLI (synthetic and
--data-dir), the convergence tool at its tiny size and the settings that
are not ported."""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.config import OptimConfig as JaxOptim
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.continuous import FlowMatchingLossConfig as JaxLoss
from reed_tpu.diffusion.paths import sample_time as jax_sample_time
from reed_tpu.models import sit as jax_sit
from reed_tpu.train.image import ImageTrainConfig as JaxConfig
from reed_tpu.train.image import ImageTrainer as JaxTrainer
from reed_tpu.train.image import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig, OptimConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.diffusion.continuous import FlowMatchingLossConfig
from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.train.image import ImageTrainConfig, ImageTrainer, make_loss_fn
from torch_parity import random_params

torch.set_num_threads(1)

# a tiny SiT size, registered in both packages' size tables for these tests
TINY_SIZE = dict(depth=2, hidden_size=64, num_heads=4)
KW = dict(model="SiT-T/2", input_size=8, in_channels=4, num_classes=10,
          encoder_depth=1, encoder_depth_text=2, z_dims=(8, 6), z_types=("i", "t"),
          projector_dim=32, class_dropout_prob=0.5, batch_size=4)
LOSS = dict(enc_names=("dinov2", "qwen"), loss_weights=(1.0, 0.5))
OPTIM = dict(lr=1e-3, grad_clip=1.0)
CURRICULUM = dict(proj_coeff=0.5, diffusion_warmup_steps=0)
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4
# bf16 against reed_tpu's bf16 step. Both round the same tensors to bf16
# (the residual stream, weights cast at use, attention probabilities), but
# XLA fuses elementwise chains and keeps f32 inside a fusion where PyTorch
# rounds each op's output, so the two differ by ~1 bf16 ulp (2^-8) at many
# points, carried through two blocks forward and back. Each is then as far
# from the other as from an f32 step: at this size 2.5 % of a gradient's
# largest element (the port's f32 step against reed_tpu's bf16 one: 2.7 %),
# metrics 1.2 % (img_proj_loss, 5e-5 absolute). The bounds are twice that.
BF16_METRIC_RTOL = 2e-2
BF16_GRAD_RTOL = 5e-2


@pytest.fixture(autouse=True)
def tiny_size(monkeypatch):
    monkeypatch.setitem(jax_sit._SIZES, "SiT-T", TINY_SIZE)
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", TINY_SIZE)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    b, tokens = KW["batch_size"], (KW["input_size"] // 2) ** 2
    return {"x": rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            "y": rng.integers(0, KW["num_classes"], b).astype(np.int32),
            "zs": [rng.standard_normal((b, tokens, 8)).astype(np.float32),
                   rng.standard_normal((b, 6)).astype(np.float32)]}


def _jax_step(batch, dtype):
    """reed_tpu: (params, grads, metrics, params and EMA after one step, the
    step's draws (t, eps, drop)), all numpy."""
    cfg = JaxConfig(**KW, compute_dtype=dtype, loss=JaxLoss(**LOSS),
                    optim=JaxOptim(**OPTIM), curriculum=JaxCurriculum(**CURRICULUM),
                    mesh=JaxMesh(data=1))
    trainer = JaxTrainer(cfg)
    params = random_params(trainer.model, std=0.1, seed=0)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    # the draws of the train step at step 0 (core/trainer.py:54,
    # diffusion/continuous.py:63-68)
    step_rng = jax.random.fold_in(trainer.train_rng, 0)
    rng_t, rng_eps, rng_model = jax.random.split(step_rng, 3)
    x = jbatch["x"]
    t = jax_sample_time(rng_t, x.shape[0], cfg.loss.weighting, cfg.loss.path_type)
    eps = jax.random.normal(rng_eps, x.shape, x.dtype)
    # the labels that reach the label table, dropped ones set to the null class
    seen = []

    def capture(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Embed) and context.method_name == "__call__":
            seen.append(np.asarray(args[0]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(capture):
        trainer.model.apply({"params": jparams}, x, t, jbatch["y"], train=True,
                            rngs={"label_dropout": rng_model})
    (y_seen,) = seen
    drop = (y_seen == KW["num_classes"]) & (batch["y"] != KW["num_classes"])
    loss_fn = jax_make_loss_fn(trainer.model, cfg.loss)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, cfg.curriculum)[0]))(jparams)
    state = trainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=trainer.optimizer.init(jparams))
    state, metrics = trainer.train_step(state, jbatch, trainer.train_rng)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return (params, to_np(grads), {k: float(v) for k, v in metrics.items()},
            to_np(state.params), to_np(state.ema_params),
            (np.asarray(t), np.asarray(eps), drop))


def _port_trainer(params, dtype, **cfg_kw):
    cfg = ImageTrainConfig(**KW, compute_dtype=dtype, loss=FlowMatchingLossConfig(**LOSS),
                           optim=OptimConfig(**OPTIM),
                           curriculum=CurriculumConfig(**CURRICULUM), **cfg_kw)
    trainer = ImageTrainer(cfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(params, 2))
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(cfg.optim, list(state.model.parameters()))
    return cfg, trainer, state


def _port_grads(cfg, state, batch, draws):
    tbatch = {"x": torch.tensor(batch["x"]), "y": torch.tensor(batch["y"]).long(),
              "zs": [torch.tensor(z) for z in batch["zs"]]}
    t, eps, drop = (torch.tensor(a) for a in draws)
    metrics = make_loss_fn(cfg.loss)(state.model, tbatch, 0, t=t, eps=eps, drop=drop)
    total, _ = combine_losses(metrics, 0, cfg.curriculum)
    names, leaves = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, g, p in zip(names, grads, leaves)}


def test_train_step_matches_jax_f32():
    """Metrics to 1e-5; every parameter's gradient to 5e-4; parameters after
    one Adam step to 2e-6 where reed_tpu's gradient exceeds 1e-6 (there the
    first update is lr * g / (|g| + eps), insensitive to the gradient's last
    digits) and to 2 * lr elsewhere; the EMA after the step to 1e-6."""
    batch = _batch()
    params, jgrads, jmetrics, jparams1, jema1, draws = _jax_step(batch, "float32")
    assert draws[2].any() and not draws[2].all()  # some labels dropped, not all
    cfg, trainer, state = _port_trainer(params, "float32")
    want = state_dict_from_flax(jgrads, 2)
    got = _port_grads(cfg, state, batch, draws)
    assert set(want) == set(got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)

    state, pmetrics = trainer.train_step(state, batch, *(torch.tensor(a) for a in draws))
    assert state.step == 1 and set(pmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), v, rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)
    lr = cfg.optim.lr
    after, ema_after = state_dict_from_flax(jparams1, 2), state_dict_from_flax(jema1, 2)
    for name, p in state.model.named_parameters():
        big = want[name].abs() > 1e-6
        diff = (p.detach() - after[name]).abs()
        if big.any():
            assert diff[big].max().item() <= 2e-6, name
        assert diff.max().item() <= 2 * lr, name
        np.testing.assert_allclose(state.ema[name].numpy(), ema_after[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_train_step_matches_jax_bf16():
    """bf16 compute with f32 master weights against reed_tpu's bf16 step, at
    BF16_METRIC_RTOL / BF16_GRAD_RTOL; the gradients and the parameters stay
    f32. The bf16 step is also held against the f32 one: a bf16 path that
    dropped its casts would match the f32 step exactly."""
    batch = _batch()
    params, jgrads, jmetrics, _, _, draws = _jax_step(batch, "bfloat16")
    cfg, trainer, state = _port_trainer(params, "bfloat16")
    want = state_dict_from_flax(jgrads, 2)
    got = _port_grads(cfg, state, batch, draws)
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        err = (g - want[name]).abs().max() / want[name].abs().max().clamp_min(1e-30)
        assert err <= BF16_GRAD_RTOL, (name, float(err))
    cfg32, _, state32 = _port_trainer(params, "float32")
    got32 = _port_grads(cfg32, state32, batch, draws)
    assert max(float((got[n] - got32[n]).abs().max()) for n in got) > 1e-5
    # the residual stream and the projector outputs are bf16, the velocity f32
    seen = {}
    for name in ("blocks.0", "projectors.1", "final_layer"):
        state.model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: seen.update({name: o.dtype}))
    v, zs = state.model(torch.tensor(batch["x"]), torch.tensor(draws[0]),
                        torch.tensor(batch["y"]).long(), train=True)
    assert set(seen.values()) == {torch.bfloat16} and len(seen) == 3
    assert v.dtype == torch.float32 and [z.dtype for z in zs] == [torch.bfloat16] * 2

    state, pmetrics = trainer.train_step(state, batch, *(torch.tensor(a) for a in draws))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), v, rtol=BF16_METRIC_RTOL,
                                   atol=1e-3, err_msg=k)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(e.dtype == torch.float32 for e in state.ema.values())


@pytest.mark.parametrize("accum_steps,ema_every", [(1, 8), (2, 1), (2, 3)])
def test_ema_moves_on_committed_updates_every_ema_every(accum_steps, ema_every):
    """As reed_tpu/core/trainer.py:72-79: the EMA moves only on the micro-step
    that commits an update, and then only every ema_every optimizer steps,
    with decay ** ema_every."""
    cfg = ImageTrainConfig(**{**KW, "batch_size": 2}, compute_dtype="float32",
                           optim=OptimConfig(lr=1e-3, accum_steps=accum_steps),
                           curriculum=CurriculumConfig(diffusion_warmup_steps=0,
                                                       ema_decay=0.9, ema_every=ema_every))
    trainer = ImageTrainer(cfg, device="cpu")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(0))
    period = accum_steps * ema_every
    ema = {k: v.clone() for k, v in state.ema.items()}
    for step in range(2 * period):
        state, _ = trainer.train_step(state, batch)
        moved = any(not torch.equal(ema[k], state.ema[k]) for k in ema)
        assert moved == (step % period == period - 1), step
        if moved:
            for name, p in state.model.named_parameters():
                decay = 0.9 ** ema_every
                torch.testing.assert_close(state.ema[name],
                                           ema[name] * decay + p.detach() * (1 - decay))
            ema = {k: v.clone() for k, v in state.ema.items()}
    assert state.opt.count == 2 * ema_every


TINY_CLI = ["--model", "SiT-T/2", "--device", "cpu", "--batch-size", "2", "--set", "encoder_depth=1",
            "--set", "input_size=8", "--set", "num_classes=10", "--set", "projector_dim=16",
            "--set", "curriculum.diffusion_warmup_steps=0"]


def test_cli_train_image_synthetic_on_cpu(capsys):
    from reed_tpu_torch import cli

    state = cli.main(["train-image", "--steps", "3", "--synthetic", "--log-every", "1",
                      *TINY_CLI, "--set", "optim.mu_dtype=bfloat16",
                      "--set", "z_dims=[8,6]", "--set", 'z_types=["i","t"]',
                      "--set", "encoder_depth_text=2",
                      "--set", 'loss.enc_names=["dinov2","qwen"]',
                      "--set", "loss.loss_weights=[1.0,0.5]"])
    assert state.step == 3 and state.opt.mu[0].dtype == torch.bfloat16
    out = capsys.readouterr().out
    assert "[step 3]" in out and "samples_per_sec" in out and "imgs/s" in out
    assert "'text_proj_loss': 0.0," not in out  # the text projector is trained


def _write_latents(root, n, seed=0):
    """A cached-latent tree: dataset.json, vae-sd/*.npy moments [8, 8, 8],
    per-token features [16, 8] and pooled text embeddings [6]."""
    rng = np.random.default_rng(seed)
    for sub in ("vae-sd", "features/dinov2", "text_embeds_qwen"):
        (root / sub).mkdir(parents=True)
    labels = []
    for i in range(n):
        for sub, shape in (("vae-sd", (8, 8, 8)), ("features/dinov2", (16, 8)),
                           ("text_embeds_qwen", (6,))):
            np.save(root / sub / f"img{i:03d}.npy",
                    rng.standard_normal(shape).astype(np.float32))
        labels.append([f"img{i:03d}.png", int(i % 10)])
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))


def test_data_dir_batches_match_jax_and_train(tmp_path, capsys):
    from reed_tpu.data import image as jax_data
    from reed_tpu_torch import cli
    from reed_tpu_torch.data import image as port_data

    _write_latents(tmp_path, 7)
    for kw in ({}, dict(features_subdirs=("features/dinov2",),
                        text_embeds_subdir="text_embeds_qwen")):
        want = list(jax_data.epoch_batches(jax_data.CachedLatentDataset(
            jax_data.ImageDatasetConfig(str(tmp_path), **kw)), 2, 5))
        got = list(port_data.epoch_batches(port_data.CachedLatentDataset(
            port_data.ImageDatasetConfig(str(tmp_path), **kw)), 2, 5))
        assert len(got) == len(want) == 3  # full batches only
        for a, b in zip(got, want):
            assert set(a) == set(b) and len(a["zs"]) == len(b["zs"]) == 2 * bool(kw)
            for k in ("x", "y"):
                np.testing.assert_array_equal(a[k], b[k])
            for za, zb in zip(a["zs"], b["zs"]):
                np.testing.assert_array_equal(za, zb)
        assert got[0]["x"].shape == (2, 8, 8, 4)

    state = cli.main(["train-image", "--data-dir", str(tmp_path), "--steps", "4",
                      "--log-every", "2", *TINY_CLI])
    out = capsys.readouterr().out
    # no feature subdirectories: zs is empty and proj_loss 0, as reed_tpu's CLI
    assert state.step == 4 and "[step 4]" in out and "'proj_loss': 0.0" in out


def test_run_loops_over_batches_and_logs():
    cfg = ImageTrainConfig(**{**KW, "batch_size": 2}, compute_dtype="float32")
    trainer = ImageTrainer(cfg, device="cpu")
    batches = [trainer.synthetic_batch(torch.Generator().manual_seed(i)) for i in range(4)]
    logged = []
    state = trainer.run(trainer.init_state(), batches, log_every=2, log_fn=logged.append)
    assert state.step == 4 and len(logged) == 2
    assert all(isinstance(v, float) and np.isfinite(v) for m in logged for v in m.values())


def test_convergence_tool_runs_tiny(tmp_path):
    from reed_tpu_torch.tools import convergence_image

    out = tmp_path / "c.json"
    result = convergence_image.main(["--tiny", "--device", "cpu", "--steps", "20",
                                     "--sampler-steps", "4", "--model", "SiT-T/4",
                                     "--out", str(out)])
    assert out.exists() and result["steps"] == 20 and result["platform"] == "cpu"
    (run,) = result["runs"]  # --tiny: the first seed only
    assert run["seed"] == 0 and 0.0 <= run["final"]["class_accuracy"] <= 1.0
    assert len(run["loss_curve"]) == 2 and result["bar"] == 1.0
    assert result["median_final"] == run["final"]["class_accuracy"]
    assert result["pass"] == (run["final"]["class_accuracy"] >= 1.0)


def test_unported_settings_raise(tmp_path):
    """The tensor and seq axes are ported (tests/test_torch_tensor_parallel.py):
    --sp 2 on one process raises naming the torchrun line; remat is ported
    (tests/test_torch_remat.py): True and 'dots' train, an unknown policy
    raises; --fsdp 2 and data=2 without two ranks raise naming torchrun;
    the flags ported since (--ckpt-dir, --sample-every, --enc-type, --vae,
    --ref-ckpt; tests/test_torch_image_eval_cli.py) no longer do."""
    from reed_tpu_torch import cli

    for remat in (True, "dots"):
        trainer = ImageTrainer(ImageTrainConfig(**KW, remat=remat), device="cpu")
        state = trainer.init_state()
        assert state.model.remat_saves == (() if remat is True else ("mm", "addmm"))
        state, _ = trainer.train_step(state, trainer.synthetic_batch())
        assert state.step == 1
    with pytest.raises(ValueError, match="remat policy"):
        ImageTrainer(ImageTrainConfig(**KW, remat="dots_only"), device="cpu").init_state()
    with pytest.raises(ValueError, match="torchrun"):
        ImageTrainer(ImageTrainConfig(**KW, mesh=MeshConfig(data=2)), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        ImageTrainer(ImageTrainConfig(**KW, attn_impl="flash"), device="cpu").init_state()
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["train-image", "--steps", "1", *TINY_CLI, "--dp", "2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(["train-image", "--steps", "1", *TINY_CLI, "--fsdp", "2"])
    with pytest.raises(ValueError, match="seq=2 does not divide the 1 process.*"
                                         "torchrun --nproc_per_node 2"):
        cli.main(["train-image", "--steps", "1", *TINY_CLI, "--sp", "2"])
    assert cli.main(["train-image", "--steps", "1", "--dp", "1", *TINY_CLI]).step == 1
    state = cli.main(["train-image", "--steps", "1", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "1", *TINY_CLI])
    assert state.step == 1 and (tmp_path / "1.pt").exists()


def test_attn_impl_names_and_compute_dtype():
    """reed_tpu's attn_impl names map to the kernel ('auto', 'pallas') or to
    plain attention ('xla'); the parameters are f32 and the model computes in
    compute_dtype."""
    for name, want in (("auto", "auto"), ("pallas", "auto"), ("xla", "reference")):
        cfg = ImageTrainConfig(**KW, attn_impl=name)
        state = ImageTrainer(cfg, device="cpu").init_state()
        assert state.model.attn_impl == want
    assert state.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    assert ImageTrainer(cfg, device="cpu").init_state().model.compute_dtype == torch.float32
