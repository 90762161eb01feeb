"""The port's SemlaFlow subcommands through cli.main on the CPU at tiny
widths: recipes/molecule_semla_reed.json resolves to the configuration
reed_tpu resolves; train-molecule-semla on synthetic batches with
--ckpt-dir (save, then resume), on a fabricated .rsmol dataset with
reps.npy, and from a reference checkpoint; eval-semla from the run's EMA
with --out files and from --ref-ckpt; the alternative architectures
(egnn, eqgat) through both subcommands, the refused architecture and
dtype, and training in mixed precision; the gates' configurations
(f32 chains and the bf16 templates record) and tiny runs."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from reed_tpu.core import configlib as jax_configlib
from reed_tpu.train.molecule_semla import SemlaTrainConfig as JaxConfig
from reed_tpu_torch import cli
from reed_tpu_torch.core import configlib
from reed_tpu_torch.data.molecule import GeometricMol, save_dataset
from reed_tpu_torch.train.molecule_semla import SemlaTrainConfig, build_model

torch.set_num_threads(1)
RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "molecule_semla_reed.json")
TINY = ["--set", "d_model=32", "--set", "d_message=16", "--set", "n_layers=3",
        "--set", "n_coord_sets=4", "--set", "d_message_hidden=16", "--set", "d_edge=8",
        "--set", "n_attn_heads=4", "--set", "size_emb=8", "--set", "d_rep=16",
        "--set", "max_atoms=32", "--device", "cpu"]


def test_recipe_resolves_as_in_reed_tpu():
    ours = configlib.merge(configlib.build(SemlaTrainConfig), configlib.load_file(RECIPE))
    ref = jax_configlib.merge(jax_configlib.build(JaxConfig),
                              jax_configlib.load_file(RECIPE))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.d_model, ours.n_layers, ours.n_coord_sets, ours.n_attn_heads,
            ours.d_rep, tuple(ours.align_depth)) == (384, 12, 64, 32, 512, (4,))
    assert ours.optim.schedule == "onecycle" and ours.diffusion_loss_max_step == 30000
    assert dataclasses.asdict(configlib.build(SemlaTrainConfig)) == \
        dataclasses.asdict(jax_configlib.build(JaxConfig))


def _log_steps(text):
    return [int(line.split("]")[0].split()[1]) for line in text.splitlines()
            if line.startswith("[step ")]


def test_train_synthetic_resume_and_eval(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main(["train-molecule-semla", "--config", RECIPE, "--synthetic", "--steps", "2",
              "--batch-size", "2", "--log-every", "1", "--ckpt-dir", run,
              "--ckpt-every", "2", "--set", "diffusion_loss_max_step=0", *TINY])
    first = capsys.readouterr().out
    assert _log_steps(first) == [1, 2] and "molecules/s" in first
    assert {"2.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(run))
    state = cli.main(["train-molecule-semla", "--config", RECIPE, "--synthetic", "--steps",
                      "2", "--batch-size", "2", "--log-every", "1", "--ckpt-dir", run,
                      "--ckpt-every", "2", "--set", "diffusion_loss_max_step=0", *TINY])
    second = capsys.readouterr().out
    assert "resumed from step 2" in second and _log_steps(second) == [3, 4]
    assert state.step == 4 and "4.pt" in os.listdir(run)

    out = str(tmp_path / "mols")
    summary = cli.main(["eval-semla", "--config", RECIPE, "--ckpt-dir", run,
                        "--n-samples", "3", "--n-replicates", "2", "--num-steps", "3",
                        "--n-atoms-min", "4", "--n-atoms-max", "7", "--out", out, *TINY])
    text = capsys.readouterr().out
    assert "loaded EMA weights of step 4" in text and "ms per integrator step" in text
    assert json.loads(text.strip().splitlines()[-1]) == summary
    assert summary["n_samples"] == 3 and 0.0 <= summary["validity"] <= 1.0
    assert sorted(os.listdir(out)) == [f"mol_{i:04d}.{e}" for i in range(3)
                                       for e in ("sdf", "xyz")]
    with open(os.path.join(out, "mol_0000.xyz")) as f:
        n = int(f.readline())
    assert 4 <= n <= 7


def test_train_on_rsmol_dataset(tmp_path, capsys):
    rng = np.random.default_rng(0)
    mols = []
    for n in rng.integers(4, 12, size=10):
        bonds = np.array([[i, i + 1] for i in range(n - 1)], np.int32)
        mols.append(GeometricMol(rng.standard_normal((n, 3)).astype(np.float32),
                                 rng.integers(2, 10, n).astype(np.int32), bonds,
                                 np.ones(len(bonds), np.int32), np.zeros(n, np.int32)))
    data = tmp_path / "qm9"
    data.mkdir()
    save_dataset(str(data / "train.rsmol"), mols)
    np.save(data / "reps.npy", rng.standard_normal((10, 16)).astype(np.float32))
    cli.main(["train-molecule-semla", "--data-dir", str(data), "--batch-cost", "48",
              "--steps", "3", "--log-every", "1", "--set", "cond_type=adaLN",
              "--set", "align_depth=[1]", *TINY])
    text = capsys.readouterr().out
    assert "loaded 10 molecules" in text and _log_steps(text) == [1, 2, 3]
    losses = [json.loads(line.split("] ", 1)[1].replace("'", '"'))["proj_loss"]
              for line in text.splitlines() if line.startswith("[step ")]
    assert all(np.isfinite(losses)) and any(v != 0 for v in losses)
    np.save(data / "reps.npy", np.zeros((9, 16), np.float32))
    with pytest.raises(ValueError, match="reps"):
        cli.main(["train-molecule-semla", "--data-dir", str(data), "--steps", "1", *TINY])


def test_ref_ckpt_warm_start_and_eval(tmp_path, capsys):
    cfg = configlib.apply_overrides(configlib.build(SemlaTrainConfig), [
        "d_model=32", "d_message=16", "n_layers=3", "n_coord_sets=4",
        "d_message_hidden=16", "d_edge=8", "n_attn_heads=4", "size_emb=8", "d_rep=16",
        "max_atoms=32"])
    model = build_model(cfg, generator=torch.Generator().manual_seed(5))
    sd = model.state_dict()
    sd["size_emb.weight"] = sd["size_emb.weight"][:-1]  # the reference's table
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": {f"ema_gen.module.{k}": v for k, v in sd.items()}}, path)
    state = cli.main(["train-molecule-semla", "--ref-ckpt", path, "--steps", "1",
                      "--batch-size", "2", *TINY])
    assert "warm-started from reference checkpoint" in capsys.readouterr().out
    assert state.step == 1
    cli.main(["eval-semla", "--ref-ckpt", path, "--n-samples", "2", "--n-replicates", "1",
              "--num-steps", "2", "--n-atoms-min", "3", "--n-atoms-max", "5", *TINY])
    assert "loaded reference checkpoint" in capsys.readouterr().out


@pytest.mark.parametrize("override", ["compute_dtype=bfloat16", "arch=egnn", "arch=eqgat"])
def test_refused_configurations(override):
    if override == "compute_dtype=bfloat16":
        # mixed precision is ported: training runs in it, and a dtype the
        # port does not compute in is refused
        state = cli.main(["train-molecule-semla", "--set", override, "--steps", "1", *TINY])
        assert state.step == 1
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            cli.main(["train-molecule-semla", "--set", "compute_dtype=float16", "--steps",
                      "1", *TINY])
        return
    # the alternative generators are ported: both subcommands run them, and
    # an architecture reed_tpu does not have is refused
    state = cli.main(["train-molecule-semla", "--set", override, "--steps", "1", *TINY])
    assert state.step == 1
    cli.main(["eval-semla", "--set", override, "--n-samples", "2", "--n-replicates", "1",
              "--num-steps", "1", "--n-atoms-min", "3", "--n-atoms-max", "5", *TINY])
    with pytest.raises(ValueError, match="semla, egnn or eqgat"):
        cli.main(["eval-semla", "--set", "arch=gvp", "--num-steps", "1", *TINY])


def test_gate_defaults_are_the_tpu_record():
    from reed_tpu_torch.tools import convergence_semla as gate

    with open(os.path.join(os.path.dirname(RECIPE), "..", "CONVERGENCE_SEMLA.json")) as f:
        record = json.load(f)
    rec = record["config"]
    cfg = gate.gate_config()
    data = gate.GateData()
    assert (cfg.batch_size, cfg.d_model, cfg.n_layers, cfg.n_coord_sets, cfg.optim.lr,
            cfg.optim.schedule, cfg.optim.warmup_steps, cfg.integrator.steps,
            cfg.compute_dtype, cfg.coord_skip, cfg.interpolant.coord_noise_std,
            cfg.integrator.cat_noise_level, cfg.self_cond,
            cfg.integrator.type_strategy, cfg.cond_type != "none") == (
        rec["batch_size"], rec["d_model"], rec["layers"], rec["coord_sets"], rec["lr"],
        rec["schedule"], rec["warmup"], rec["integrator_steps"], rec["dtype"],
        rec["coord_skip"], rec["train_coord_noise"], rec["cat_noise_level"],
        rec["self_cond"], rec["categorical_strategy"], rec["rep_condition"])
    assert abs(data.coord_std - rec["coord_std"]) < 1e-6
    assert len(data.family) == rec["n_classes"] and cfg.optim.total_steps == record["steps"]
    assert gate.STEPS == record["steps"] and gate.BAR == 0.95
    batch = data.batch(3)
    assert batch["rep"].dtype == np.float32 and batch["interpolated"]["coords"].shape == (
        128, data.max_n, 3)


def test_gate_runs_tiny(tmp_path):
    from reed_tpu_torch.tools import convergence_semla as gate

    out = tmp_path / "g.json"
    result = gate.main(["--tiny", "--device", "cpu", "--steps", "6", "--integrator-steps",
                        "3", "--n-eval", "8", "--workers", "0", "--out", str(out)])
    assert out.exists() and result["steps"] == 6 and result["platform"] == "cpu"
    (run,) = result["runs"]
    assert run["seed"] == 0 and len(run["loss_curve"]) == 2
    assert result["median_final_ema"]["validity"] == run["final_ema"]["validity"]
    assert result["pass"] == (run["final_ema"]["validity"] >= 0.95)


def test_bf16_gate_is_the_bf16_record(tmp_path):
    """--templates is the configuration of CONVERGENCE_SEMLA_BF16.json (the
    JAX tool of commit c76e714: the templates family, no reps, constant lr,
    no coordinate or categorical noise, type loss weight 1, 3,000 steps),
    and --dtype bfloat16 runs it in mixed precision under the f32 gate's
    rule."""
    from reed_tpu_torch.data.synthetic import MOLECULE_TEMPLATES
    from reed_tpu_torch.tools import convergence_semla as gate

    with open(os.path.join(os.path.dirname(RECIPE), "..", "CONVERGENCE_SEMLA_BF16.json")) as f:
        record = json.load(f)
    rec = record["config"]
    cfg = gate.gate_config(templates=True, dtype="bfloat16")
    assert (cfg.batch_size, cfg.d_model, cfg.n_layers, cfg.n_coord_sets, cfg.optim.lr,
            cfg.integrator.steps, cfg.compute_dtype) == (
        rec["batch_size"], rec["d_model"], rec["layers"], rec["coord_sets"], rec["lr"],
        rec["integrator_steps"], rec["dtype"])
    assert gate.TEMPLATE_STEPS == record["steps"]
    assert (cfg.d_rep, cfg.rep_alignment, cfg.optim.schedule, cfg.optim.grad_clip,
            cfg.interpolant.coord_noise_std, cfg.integrator.cat_noise_level,
            cfg.type_loss_weight, cfg.curriculum.ema_decay) == (
        None, False, "constant", 1.0, 0.0, 0.0, 1.0, 0.995)
    data = gate.GateData(templates=True)
    assert data.family is MOLECULE_TEMPLATES and data.coord_std == 1.0
    assert "rep" not in data.batch(3)
    out = tmp_path / "b.json"
    result = gate.main(["--tiny", "--templates", "--dtype", "bfloat16", "--device", "cpu",
                        "--steps", "4", "--integrator-steps", "3", "--n-eval", "8",
                        "--workers", "0", "--out", str(out)])
    assert result["config"]["dtype"] == "bfloat16" and result["config"]["family"] == "templates"
    assert "bonds from distances" in result["metric"] and result["bar"] == 0.95
