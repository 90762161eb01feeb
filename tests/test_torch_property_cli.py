"""reed_tpu_torch's train-property and eval-conditional through cli.main on
the CPU at tiny widths, mirroring tests/test_property.py with --device cpu,
and one property-conditioned EDM step against reed_tpu's (the model that
eval-conditional samples)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.train import property as jprop
from reed_tpu_torch.cli import main
from test_torch_property import METRIC_TOL, _qm9_like

torch.set_num_threads(1)
CLI_TINY = ["--set", "hidden_nf=16", "--set", "n_layers=1", "--set", "max_nodes=8",
            "--set", "num_atom_types=4", "--dp", "1", "--fsdp", "1", "--tp", "1",
            "--device", "cpu"]


def test_conditional_edm_step_matches_reed_tpu():
    """A property-conditioned EDM model (context_node_nf 1, the context on
    every node, no rep, as eval-conditional's tests run it) with reed_tpu's
    draws: every gradient to 5e-4 of its max (as
    tests/test_torch_edm_train.py holds the unconditioned one); one whole
    MoleculeEDMTrainer step against reed_tpu's jitted one, the losses to
    1e-5 and grad_norm to 1e-4 (reed_tpu's jitted step and its separately
    jitted gradient differ by ~1.4e-5 in that norm here)."""
    import test_torch_edm_train as edm_parity
    from reed_tpu.core.trainer import combine_losses as jax_combine_losses
    from reed_tpu.train import molecule_edm as jme
    from reed_tpu_torch.core.trainer import combine_losses
    from reed_tpu_torch.encoders.edm_convert import state_dict_from_flax
    from reed_tpu_torch.train import molecule_edm as me

    jcfg, tcfg = edm_parity._configs(context_node_nf=1, rep_nf=None)
    jtrainer = jme.MoleculeEDMTrainer(jcfg)
    trainer, tstate, params = edm_parity._port_state(tcfg)
    # embedding input: 5 types, the charge, t and the context
    assert tstate.model.egnn.embedding.weight.shape[1] == 5 + 1 + 1 + 1
    batch = edm_parity._batch(tcfg.rep_nf)
    ctx = np.random.default_rng(5).standard_normal((batch["node_mask"].shape[0], 1, 1))
    batch["context"] = (np.broadcast_to(ctx, batch["node_mask"].shape)
                        * batch["node_mask"]).astype(np.float32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, params)
    key, draws = edm_parity._key_with_drop(jcfg, jbatch, jparams, jtrainer.model)
    loss_fn = jme.make_loss_fn(jtrainer.model, jcfg)
    step_rng = jax.random.fold_in(key, 0)
    jgrads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, jcfg.curriculum)[0]))(jparams)
    want = state_dict_from_flax(jax.tree.map(np.array, jgrads))
    tbatch = me.batch_to_device(batch, "cpu")
    loss, _ = combine_losses(me.make_loss_fn(tcfg)(tstate.model, tbatch, 0, **draws), 0,
                             tcfg.curriculum)
    names, leaves = zip(*tstate.model.named_parameters())
    for name, g, p in zip(names, torch.autograd.grad(loss, leaves, allow_unused=True),
                          leaves):
        g = torch.zeros_like(p) if g is None else g
        assert (g - want[name]).abs().max() <= 5e-4 * want[name].abs().max(), name

    state = jtrainer.init_state()
    state = state.replace(params=jparams, ema_params=jax.tree.map(jnp.copy, jparams),
                          opt_state=jtrainer.optimizer.init(jparams))
    state, jmetrics = jtrainer.train_step(state, jbatch, key)
    tstate, tmetrics = trainer.train_step(tstate, tbatch, **draws)
    assert set(tmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        tol = 1e-4 if k == "grad_norm" else METRIC_TOL
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=tol, atol=tol,
                                   err_msg=k)
    # the context reaches the loss: another context, another loss
    batch["context"] = -batch["context"]
    _, other = me.MoleculeEDMTrainer(tcfg, device="cpu").train_step(
        edm_parity._port_state(tcfg)[1], me.batch_to_device(batch, "cpu"), **draws)
    assert abs(float(other["loss"]) - float(tmetrics["loss"])) > 1e-6


def _last_json(text):
    lines = text.strip().splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def test_train_property_cli(tmp_path, capsys):
    """Synthetic, on a fabricated QM9-layout npz (mean and mad from its
    column, in the config snapshot), and --linear-probe on reps.npy."""
    state = main(["train-property", "--synthetic", "--steps", "3", "--batch-size", "4",
                  "--log-every", "1"] + CLI_TINY)
    assert state.step == 3
    assert "train-property alpha (cpu): 2 steps after the first" in capsys.readouterr().out
    data = _qm9_like()
    np.savez(tmp_path / "train.npz", **data)
    ckpt = str(tmp_path / "ckpt")
    main(["train-property", "--data-dir", str(tmp_path), "--property", "alpha", "--steps",
          "10", "--batch-size", "8", "--log-every", "5", "--ckpt-dir", ckpt,
          "--ckpt-every", "5"] + CLI_TINY)
    snap = json.load(open(f"{ckpt}/config.json"))
    mean, mad = jprop.compute_mean_mad(data["alpha"])
    assert snap["property"] == "alpha" and snap["hidden_nf"] == 16
    assert snap["mean"] == pytest.approx(mean) and snap["mad"] == pytest.approx(mad)
    assert {"5.pt", "10.pt"} <= set(os.listdir(ckpt))
    np.save(tmp_path / "reps.npy", np.random.default_rng(0).standard_normal(
        (len(data["num_atoms"]), 12)).astype(np.float32))
    probe = str(tmp_path / "probe")
    state = main(["train-property", "--linear-probe", "--data-dir", str(tmp_path),
                  "--property", "alpha", "--steps", "10", "--batch-size", "8",
                  "--log-every", "5", "--ckpt-dir", probe, "--ckpt-every", "5",
                  "--device", "cpu"])
    assert json.load(open(f"{probe}/config.json"))["rep_dim"] == 12
    assert tuple(state.model.weight.shape) == (1, 12)
    with pytest.raises(SystemExit, match="fewer than one batch of 96"):
        main(["train-property", "--linear-probe", "--data-dir", str(tmp_path), "--steps", "1",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="not in npz keys"):
        main(["train-property", "--data-dir", str(tmp_path), "--property", "gap",
              "--steps", "1"] + CLI_TINY)
    # --dp 2 needs two ranks (torchrun ... --distributed); --tp is not ported
    with pytest.raises(ValueError, match="torchrun"):
        main(["train-property", "--synthetic", "--steps", "1", "--dp", "2",
              "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["train-property", "--synthetic", "--steps", "1", "--tp", "2",
              "--device", "cpu"])


def test_eval_conditional_cli(tmp_path, capsys):
    data = _qm9_like()
    np.savez(tmp_path / "train.npz", **data)
    out = main(["eval-conditional", "--data-dir", str(tmp_path), "--property", "alpha",
                "--n-samples", "4", "--n-replicates", "2", "--num-steps", "5",
                "--set", "rep_nf=null"] + CLI_TINY)
    text = capsys.readouterr().out
    assert _last_json(text) == out
    assert out["property"] == "alpha" and np.isfinite(out["mae"]) and out["n_samples"] == 8
    assert "molecules/s" in text and "6 evaluations a batch" in text


def test_eval_conditional_sweep_cli(tmp_path, capsys):
    data = _qm9_like()
    np.savez(tmp_path / "train.npz", **data)
    out_dir = str(tmp_path / "viz")
    out = main(["eval-conditional", "--data-dir", str(tmp_path), "--sweep", "--property",
                "alpha", "--n-samples", "4", "--n-replicates", "1", "--num-steps", "5",
                "--out", out_dir, "--set", "rep_nf=null"] + CLI_TINY)
    targets = [r["target"] for r in out["sweep"]]
    assert targets == sorted(targets)
    assert targets[0] == pytest.approx(float(data["alpha"].min()))
    assert targets[-1] == pytest.approx(float(data["alpha"].max()))
    xyzs = sorted(f for f in os.listdir(out_dir) if f.endswith(".xyz"))
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert len(xyzs) == 4 and len(pngs) == 4
    vals = [float(v) for v in open(f"{out_dir}/property_values.log").read().splitlines()]
    assert vals == pytest.approx(targets, rel=1e-5)
    with open(f"{out_dir}/mol_000.xyz") as f:
        assert f.read().splitlines()[1] == f"alpha={targets[0]:.4f}"
    # one size for the sweep: the median of the split's sizes
    natoms = {int(f.read().split()[0]) for f in
              (open(os.path.join(out_dir, x)) for x in xyzs)}
    assert natoms == {int(np.median(np.minimum(data["num_atoms"], 8)))}


def test_eval_conditional_restores_trained_classifier(tmp_path, capsys):
    """train-property --ckpt-dir, then eval-conditional --classifier-ckpt
    (the classifier rebuilt from its config.json, its EMA loaded), and the
    EDM model from a train-molecule-edm run with context_node_nf 1."""
    data = _qm9_like()
    np.savez(tmp_path / "train.npz", **data)
    clf, gen = str(tmp_path / "clf"), str(tmp_path / "gen")
    main(["train-property", "--data-dir", str(tmp_path), "--property", "alpha", "--steps",
          "10", "--batch-size", "8", "--log-every", "5", "--ckpt-dir", clf,
          "--ckpt-every", "5"] + CLI_TINY)
    main(["train-molecule-edm", "--synthetic", "--steps", "2", "--batch-size", "2",
          "--ckpt-dir", gen, "--ckpt-every", "2", "--set", "context_node_nf=1",
          "--set", "rep_nf=null", "--set", "edm.timesteps=5"] + CLI_TINY[:8]
         + ["--device", "cpu"])
    capsys.readouterr()
    out = main(["eval-conditional", "--data-dir", str(tmp_path), "--property", "alpha",
                "--n-samples", "4", "--n-replicates", "1", "--num-steps", "5",
                "--classifier-ckpt", clf, "--ckpt-dir", gen, "--set", "rep_nf=null"]
               + CLI_TINY)
    text = capsys.readouterr().out
    assert f"loaded EMA weights of step 10 from {clf}" in text
    assert f"loaded EMA weights of step 2 from {gen}" in text
    assert np.isfinite(out["mae"])
