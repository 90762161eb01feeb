"""reed_tpu_torch's protein train step against reed_tpu's ProteinTrainer on
the CPU: one full step of a tiny fused ProteinMPNN-FMIF (hidden 32, 2 + 2
layers, K 6, batch 2 x 16, projector widths 8/4/8, dropout 0, the denoising
loss on from step 0) with the same weights, the same batch and reed_tpu's
corrupted tokens and t injected. reed_tpu runs its fused chain as the Pallas
kernels in interpret mode (K2b included in its gradient); the port runs the
plain chain with autograd. Then the training half of the model (dropout,
detach_repr, learnable_node) and a short run whose loss falls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.discrete import corrupt_batch as jax_corrupt_batch
from reed_tpu.train.protein import ProteinTrainConfig as JaxConfig
from reed_tpu.train.protein import ProteinTrainer as JaxTrainer
from reed_tpu.train.protein import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core.config import CurriculumConfig, MeshConfig
from reed_tpu_torch.core.ema import ema_init
from reed_tpu_torch.core.train_state import make_optimizer
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax
from reed_tpu_torch.models import pmpnn
from reed_tpu_torch.train.protein import (ProteinTrainConfig, ProteinTrainer,
                                          make_loss_fn)
from torch_parity import fmif_batch, fmif_random_params

torch.set_num_threads(1)

TINY = dict(hidden_dim=32, num_encoder_layers=2, num_decoder_layers=2,
            k_neighbors=6, dropout=0.0, single_dim=8, pair_dim=4,
            structure_dim=8, batch_size=2, max_len=16, fused_messages="on")
METRIC_TOL = 1e-5
GRAD_TOL = 5e-4


def _batch(pad=0, seed=1):
    batch = fmif_batch(batch=2, length=16, pad=pad, seed=seed)
    rng = np.random.default_rng(seed + 10)
    for key, shape in (("repr_single", (16, 8)), ("repr_pair", (16, 16, 4)),
                       ("repr_structure", (16, 8))):
        batch[key] = rng.standard_normal((2,) + shape).astype(np.float32)
    return batch


def _jax_step(batch, **cfg_kw):
    """reed_tpu: (params, grads, metrics, params and EMA after one step,
    the step's (S_t, t)), all numpy."""
    cfg = JaxConfig(**TINY, mesh=JaxMesh(data=1),
                    curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0),
                    **cfg_kw)
    trainer = JaxTrainer(cfg)
    params = fmif_random_params(trainer.model, batch, std=0.1, seed=0)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the draws of the train step at step 0 (trainer.py:54, protein.py:113)
    step_rng = jax.random.fold_in(trainer.train_rng, 0)
    rng_corrupt = jax.random.split(step_rng, 4)[0]
    noisy = jax_corrupt_batch(rng_corrupt, jbatch, cfg.interpolant)
    curriculum = JaxCurriculum(**{**cfg.curriculum.__dict__, "proj_coeff": cfg.repr_weight})
    loss_fn = jax_make_loss_fn(trainer.model, cfg)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, curriculum)[0]))(jparams)
    state = trainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=trainer.optimizer.init(jparams))
    state, metrics = trainer.train_step(state, jbatch, trainer.train_rng)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return (params, to_np(grads), {k: float(v) for k, v in metrics.items()},
            to_np(state.params), to_np(state.ema_params),
            (np.asarray(noisy["S_t"]), np.asarray(noisy["t"])))


def _port_trainer(params, **cfg_kw):
    cfg = ProteinTrainConfig(**TINY, curriculum=CurriculumConfig(
        proj_coeff=0.2, diffusion_warmup_steps=0), **cfg_kw)
    trainer = ProteinTrainer(cfg, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_flax(params))
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(cfg.optim, list(state.model.parameters()))
    return cfg, trainer, state


@pytest.mark.parametrize("pad", [0, 3])
def test_train_step_matches_jax(pad):
    """Metrics to 1e-5; every parameter's gradient to 5e-4; parameters after
    one Adam step to 2e-6 where reed_tpu's gradient exceeds 1e-6 (there the
    first update is lr * g / (|g| + eps), insensitive to the gradient's last
    digits) and to 2 * lr elsewhere (an update of +-lr can flip sign where
    the gradient is ~0); the EMA after the step to 1e-6."""
    batch = _batch(pad=pad)
    params, jgrads, jmetrics, jparams1, jema1, noisy = _jax_step(batch)
    cfg, trainer, state = _port_trainer(params)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    noisy = tuple(torch.tensor(x) for x in noisy)

    metrics = make_loss_fn(cfg)(state.model, tbatch, 0, noisy=noisy)
    total, _ = combine_losses(metrics, 0, trainer.curriculum)
    names, leaves = zip(*state.model.named_parameters())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    want = state_dict_from_flax(jgrads)
    assert set(want) == set(names)
    for name, g, p in zip(names, grads, leaves):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)

    state, pmetrics = trainer.train_step(state, tbatch, noisy=noisy)
    assert state.step == 1 and set(pmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(pmetrics[k]), v, rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=k)

    lr = cfg.optim.lr
    after, ema_after = state_dict_from_flax(jparams1), state_dict_from_flax(jema1)
    for name, p in state.model.named_parameters():
        big = want[name].abs() > 1e-6
        diff = (p.detach() - after[name]).abs()
        if big.any():
            assert diff[big].max().item() <= 2e-6, name
        assert diff.max().item() <= 2 * lr, name
        np.testing.assert_allclose(state.ema[name].numpy(), ema_after[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def _tiny_model(**kw):
    return pmpnn.create_pmpnn(generator=torch.Generator().manual_seed(0),
                              hidden_dim=32, edge_features=32, num_encoder_layers=2,
                              num_decoder_layers=2, k_neighbors=6, single_dim=8,
                              pair_dim=4, structure_dim=8, **kw)


def _call(model, batch, **kw):
    args = [torch.tensor(batch[k]) for k in
            ("X", "S", "mask", "chain_M", "residue_idx", "chain_encoding_all")]
    return model(*args, return_rep=True, **kw)


def test_dropout_only_in_train_mode_at_six_sites(monkeypatch):
    batch = _batch()
    model = _tiny_model(dropout=0.5, augment_eps=0.0)
    calls = []
    real = pmpnn.Dropout.__call__

    def counting(self, x):
        calls.append(self.active)
        return real(self, x)

    monkeypatch.setattr(pmpnn.Dropout, "__call__", counting)
    with torch.no_grad():
        a = _call(model, batch)
        b = _call(model, batch)
        model_no_drop = _tiny_model(dropout=0.0, augment_eps=0.0)
        c = _call(model_no_drop, batch)
        eval_calls = list(calls)
        calls.clear()
        d = _call(model, batch, train=True, generator=torch.Generator().manual_seed(0))
        e = _call(model, batch, train=True, generator=torch.Generator().manual_seed(0))
    # three sites in each encoder layer and three in each decoder layer: 12
    # per call at 2 + 2 layers, active only in train mode
    assert eval_calls == [False] * 3 * 12 and calls == [True] * 2 * 12
    for x, y, z in zip(a[:4], b[:4], c[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    assert (d[0] - a[0]).abs().max() > 1e-3  # train mode drops
    torch.testing.assert_close(d[0], e[0], rtol=0, atol=0)  # seeded


def test_dropout_is_flax_inverted_dropout():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(20000)
    y = pmpnn.Dropout(0.25, True, gen)(x)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.equal(pmpnn.Dropout(0.25, False, gen)(x), x)


def test_coordinate_noise_only_in_train_mode():
    batch = _batch()
    model = _tiny_model(dropout=0.0, augment_eps=0.1)
    with torch.no_grad():
        a = _call(model, batch)
        b = _call(model, batch, train=True, generator=torch.Generator().manual_seed(0))
        model.augment_eps = 0.0
        c = _call(model, batch, train=True, generator=torch.Generator().manual_seed(0))
    assert (a[0] - b[0]).abs().max() > 1e-4
    torch.testing.assert_close(a[0], c[0], rtol=0, atol=0)


def test_detach_repr_and_frozen_node_embeds():
    batch = _batch()
    model = _tiny_model(dropout=0.0, augment_eps=0.0, learnable_node=False)
    with torch.no_grad():
        model.node_embeds.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(1))
    out = _call(model, batch, train=True, detach_repr=True)
    zs_loss = sum(z.square().sum() for z in out[1:4])
    grads = torch.autograd.grad(zs_loss, list(model.parameters()), allow_unused=True)
    touched = {n for (n, _), g in zip(model.named_parameters(), grads)
               if g is not None and g.abs().max() > 0}
    assert touched and all(n.startswith("projectors_") for n in touched)
    out = _call(model, batch, train=True)
    g_node = torch.autograd.grad(out[0].sum() + sum(z.sum() for z in out[1:4]),
                                 model.node_embeds, allow_unused=True)[0]
    assert g_node is None or g_node.abs().max() == 0


def test_projector_only_curriculum_trains_at_unit_weight():
    assert ProteinTrainer(ProteinTrainConfig(repr_weight=0.0),
                          device="cpu").curriculum.proj_coeff == 1.0
    assert ProteinTrainer(ProteinTrainConfig(repr_weight=0.3),
                          device="cpu").curriculum.proj_coeff == 0.3


def test_unported_settings_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        ProteinTrainer(ProteinTrainConfig(compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        ProteinTrainer(ProteinTrainConfig(mesh=MeshConfig(data=2)), device="cpu")


def test_loss_falls_over_30_steps():
    cfg = ProteinTrainConfig(**{**TINY, "dropout": 0.1}, curriculum=CurriculumConfig(
        proj_coeff=0.2, diffusion_warmup_steps=0))
    trainer = ProteinTrainer(cfg, device="cpu")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(3))
    losses = []
    for _ in range(30):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_cli_train_protein_on_cpu(capsys):
    from reed_tpu_torch import cli

    state = cli.main(["train-protein", "--steps", "2", "--synthetic", "--device", "cpu",
                      "--log-every", "1", "--batch-size", "2", "--set", "max_len=16",
                      "--set", "hidden_dim=32", "--set", "k_neighbors=6",
                      "--set", "num_encoder_layers=1", "--set", "num_decoder_layers=1",
                      "--set", "curriculum.diffusion_warmup_steps=0"])
    assert state.step == 2
    out = capsys.readouterr().out
    assert "[step 1]" in out and "[step 2]" in out and "samples_per_sec" in out


def test_convergence_tool_runs_tiny(tmp_path):
    from reed_tpu_torch.tools import convergence_protein

    out = tmp_path / "c.json"
    result = convergence_protein.main(["--tiny", "--device", "cpu", "--steps", "20",
                                       "--sampler-steps", "5", "--eval-batches", "1",
                                       "--out", str(out)])
    assert out.exists() and result["steps"] == 20 and result["platform"] == "cpu"
    assert 0.0 <= result["final"] <= 1.0 and len(result["loss_curve"]) == 2


def test_cli_train_protein_from_data_dir(tmp_path, capsys):
    """The real-data branch: train-split chains of a fabricated PDB dataset,
    bucketed and featurized by data/protein.py (no repr/ dir, so the
    alignment targets are zero-filled, with a warning)."""
    from reed_tpu_torch import cli
    from test_cli_eval import _fake_pdb_dataset

    _fake_pdb_dataset(str(tmp_path))
    (tmp_path / "valid_clusters.txt").write_text("")  # every cluster trains
    state = cli.main(["train-protein", "--data-dir", str(tmp_path), "--device", "cpu",
                      "--steps", "2", "--log-every", "1", "--token-budget", "128",
                      "--set", "hidden_dim=32", "--set", "k_neighbors=6",
                      "--set", "num_encoder_layers=1", "--set", "num_decoder_layers=1",
                      "--set", "single_dim=8", "--set", "pair_dim=4",
                      "--set", "structure_dim=8"])
    out = capsys.readouterr().out
    assert state.step == 2 and "zero-filled" in out and "[step 2]" in out
