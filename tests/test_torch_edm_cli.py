"""The port's EDM subcommands through cli.main on the CPU at tiny widths:
MoleculeEDMConfig resolves to reed_tpu's; train-molecule-edm on synthetic
batches with --ckpt-dir (save, then resume) for EDM and fm, on a
fabricated QM9 EDM npz with reps.npy, and from a reference checkpoint;
eval-molecule from the run's EMA (with .xyz files), from a reference
checkpoint with a learned schedule, and with --data-dir reps, sizes and a
test split (the MOSES metrics and the MiDi distances); bf16 training, and a missing RDM checkpoint or an unknown
dtype refused; the EDM gate's defaults against the TPU record, a tiny
gate run (with its EMA curve and saved parameters) and the merge of split
runs."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.train.molecule_edm import MoleculeEDMConfig as JaxConfig
from reed_tpu_torch import cli
from reed_tpu_torch.data.molecule import GeometricMol, save_dataset
from reed_tpu_torch.diffusion.edm import GammaNetwork
from reed_tpu_torch.train.molecule_edm import MoleculeEDMConfig, build_dynamics

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(__file__), "..")
TINY = ["--set", "hidden_nf=32", "--set", "n_layers=2", "--set", "rep_nf=16",
        "--set", "max_nodes=9", "--device", "cpu"]
TINY_CFG = ["hidden_nf=32", "n_layers=2", "rep_nf=16", "max_nodes=9"]


def _log_steps(text):
    return [int(line.split("]")[0].split()[1]) for line in text.splitlines()
            if line.startswith("[step ")]


def _json_tail(text):
    return json.loads(text[text.rindex("\n{\n") + 1:])


def test_config_resolves_as_in_reed_tpu():
    ours = dataclasses.asdict(MoleculeEDMConfig())
    ref = dataclasses.asdict(JaxConfig())
    ours["mesh"], ref["mesh"] = dataclasses.asdict(JaxMesh()), dataclasses.asdict(JaxMesh())
    assert ours == ref
    cfg = MoleculeEDMConfig()
    assert (cfg.hidden_nf, cfg.n_layers, cfg.inv_sublayers, cfg.max_nodes, cfg.rep_nf,
            cfg.batch_size, cfg.normalization_factor) == (256, 9, 1, 29, 256, 64, 1.0)


@pytest.mark.parametrize("model", ["diffusion", "fm"])
def test_train_synthetic_resume_and_eval(tmp_path, capsys, model):
    run = str(tmp_path / "run")
    extra = ["--set", f"probabilistic_model={model}", "--set", "efm.ode_steps=3"]
    train = ["train-molecule-edm", "--synthetic", "--steps", "2", "--batch-size", "2",
             "--log-every", "1", "--ckpt-dir", run, "--ckpt-every", "2", *extra, *TINY]
    cli.main(train)
    first = capsys.readouterr().out
    assert _log_steps(first) == [1, 2] and "molecules/s" in first
    assert {"2.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(run))
    state = cli.main(train)
    second = capsys.readouterr().out
    assert "resumed from step 2" in second and _log_steps(second) == [3, 4]
    assert state.step == 4 and "4.pt" in os.listdir(run)

    out = str(tmp_path / "mols")
    summary = cli.main(["eval-molecule", "--ckpt-dir", run, "--num-steps", "5",
                        "--n-replicates", "2", "--batch-size", "3", "--out", out,
                        *extra, *TINY])
    text = capsys.readouterr().out
    assert "loaded EMA weights of step 4" in text and "ms per network evaluation" in text
    assert _json_tail(text) == summary
    assert set(summary) == {"mean", "std", "all"} and len(summary["all"]["validity"]) == 2
    # the .xyz files, and the 3D PNG renders (matplotlib is installed here)
    assert sorted(os.listdir(out)) == sorted(f"mol_{i:03d}.{ext}" for i in range(3)
                                             for ext in ("xyz", "png"))
    with open(os.path.join(out, "mol_000.xyz")) as f:
        assert 4 <= int(f.readline()) <= 9


def test_train_on_npz_dataset(tmp_path, capsys):
    rng = np.random.default_rng(0)
    m, n = 12, 11
    num_atoms = rng.integers(3, n + 1, size=m)
    mask = np.arange(n)[None] < num_atoms[:, None]
    data = tmp_path / "qm9"
    data.mkdir()
    np.savez(data / "train.npz",
             positions=rng.standard_normal((m, n, 3)).astype(np.float32) * mask[..., None],
             charges=rng.choice([1, 6, 7, 8, 9], size=(m, n)) * mask, num_atoms=num_atoms)
    np.save(data / "reps.npy", rng.standard_normal((m, 16)).astype(np.float32))
    state = cli.main(["train-molecule-edm", "--data-dir", str(data), "--batch-size", "4",
                      "--steps", "4", "--log-every", "1", *TINY])
    text = capsys.readouterr().out
    assert "loaded 12 molecules" in text and _log_steps(text) == [1, 2, 3, 4]
    assert state.step == 4
    np.save(data / "reps.npy", np.zeros((m - 1, 16), np.float32))
    with pytest.raises(ValueError, match="reps"):
        cli.main(["train-molecule-edm", "--data-dir", str(data), "--steps", "1", *TINY])


def test_ref_ckpt_and_data_dir_eval(tmp_path, capsys):
    from reed_tpu_torch.core import configlib

    cfg = configlib.apply_overrides(configlib.build(MoleculeEDMConfig), TINY_CFG)
    model = build_dynamics(cfg, generator=torch.Generator().manual_seed(5))
    gamma = GammaNetwork(hidden=8)
    sd = {f"module.dynamics.{k}": v for k, v in model.state_dict().items()}
    sd.update({f"module.gamma.{k}": v for k, v in gamma.state_dict().items()})
    path = str(tmp_path / "generative_model_ema.npy")
    torch.save(sd, path)
    state = cli.main(["train-molecule-edm", "--ref-ckpt", path, "--steps", "1",
                      "--batch-size", "2", *TINY])
    assert "warm-started from reference checkpoint" in capsys.readouterr().out
    assert state.step == 1
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(1)
    np.save(data / "reps.npy", rng.standard_normal((20, 16)).astype(np.float32))
    np.save(data / "sizes.npy", rng.integers(3, 12, size=20))
    # a test split in the .rsmol layout load_dataset reads: 3-atom C-C-O chains
    save_dataset(str(data / "test.rsmol.npz"), [GeometricMol(
        np.array([[0, 0, 0], [1.5, 0, 0], [2.2, 1.2, 0]], np.float32) + k,
        np.array([1, 1, 3], np.int32), np.array([[0, 1], [1, 2]], np.int32),
        np.ones(2, np.int32), np.zeros(3, np.int32)) for k in range(4)])
    out = cli.main(["eval-molecule", "--ref-ckpt", path, "--data-dir", str(data),
                    "--num-steps", "3", "--n-replicates", "1", "--batch-size", "2", *TINY])
    text = capsys.readouterr().out
    assert "(learned gamma)" in text and "GtSampler over 20 dataset reps" in text
    assert set(_json_tail(text)) == set(out) == {"mean", "std", "all", "moses", "midi"}
    assert set(out["moses"]) == {"SNN/Test", "Frag/Test", "Scaf/Test", "weight", "unique",
                                 "FCD/Test"}
    assert {"NumNodesW1", "AtomTypesTV", "EdgeTypesTV", "AnglesW1"} <= set(out["midi"])
    assert 0.0 <= out["moses"]["SNN/Test"] <= 1.0 and out["moses"]["FCD/Test"] is None


def test_refusals(tmp_path):
    # the RDM samplers are ported: a missing RDM checkpoint is what fails now
    with pytest.raises(FileNotFoundError):
        cli.main(["eval-molecule", "--rdm-ref-ckpt", str(tmp_path / "rdm.pt"), *TINY])
    state = cli.main(["train-molecule-edm", "--steps", "1", "--batch-size", "2", "--set",
                      "compute_dtype=bfloat16", *TINY])
    assert state.step == 1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cli.main(["train-molecule-edm", "--steps", "1", "--set", "compute_dtype=float16",
                  *TINY])


def test_gate_defaults_are_the_tpu_record():
    from reed_tpu_torch.tools import convergence_edm as gate

    with open(os.path.join(REPO, "CONVERGENCE_EDM.json")) as f:
        record = json.load(f)
    rec = record["config"]
    cfg = gate.gate_config()
    data = gate.GateData()
    assert (cfg.batch_size, cfg.hidden_nf, cfg.n_layers, cfg.optim.lr, cfg.optim.schedule,
            cfg.optim.warmup_steps, cfg.edm.timesteps, cfg.rep_nf is not None) == (
        rec["batch_size"], rec["hidden"], rec["layers"], rec["lr"], rec["schedule"],
        rec["warmup"], rec["timesteps"], rec["rep_condition"])
    assert len(data.family) == rec["n_classes"] and cfg.optim.total_steps == record["steps"]
    assert gate.STEPS == record["steps"] and gate.BAR == 0.95
    assert cfg.optim.grad_clip == 1.0 and cfg.curriculum.ema_decay == 0.995
    assert cfg.rep_dropout_prob == 0.0 and cfg.rep_nf == 64
    batch = data.batch(3)
    assert batch["rep"].dtype == np.float32 and batch["positions"].shape == (128, 20, 3)


def test_gate_scores_every_and_saves_params(tmp_path):
    from reed_tpu_torch.tools import convergence_edm as gate

    result = gate.main(["--device", "cpu", "--steps", "5", "--timesteps", "3",
                        "--batch-size", "4", "--hidden", "16", "--layers", "1",
                        "--n-eval", "4", "--workers", "0", "--seeds", "3",
                        "--score-every", "2", "--save-params", str(tmp_path / "p.pt"),
                        "--out", str(tmp_path / "g.json")])
    (run,) = result["runs"]
    assert [c["step"] for c in run["ema_curve"]] == [2, 4, 5]
    assert run["ema_curve"][-1]["validity"] == run["final_ema"]["validity"]
    assert result["config"]["score_every"] == 2
    saved = torch.load(tmp_path / "p_seed3.pt", weights_only=True)
    assert set(saved) == {"params", "ema", "config"} and saved["config"]["seed"] == 3
    model = build_dynamics(dataclasses.replace(gate.gate_config(3, 4, 16, 1, 5, 3)))
    model.load_state_dict(saved["params"])
    assert set(saved["ema"]) == set(saved["params"])


def test_gate_runs_tiny_and_merges(tmp_path):
    from reed_tpu_torch.tools import convergence_edm as gate

    outs = []
    for seed in (0, 1):
        out = tmp_path / f"g{seed}.json"
        result = gate.main(["--device", "cpu", "--steps", "4", "--timesteps", "3",
                            "--batch-size", "4", "--hidden", "16", "--layers", "1",
                            "--n-eval", "6", "--workers", "0", "--seeds", str(seed),
                            "--out", str(out)])
        assert out.exists() and result["steps"] == 4 and result["platform"] == "cpu"
        (run,) = result["runs"]
        assert run["seed"] == seed and len(run["loss_curve"]) == 2
        assert not result["pass"]   # one seed is no verdict
        outs.append(str(out))
    merged = gate.main(["--merge", *outs, "--out", str(tmp_path / "all.json")])
    assert merged["seeds"] == [0, 1] and len(merged["runs"]) == 2 and not merged["pass"]
    with pytest.raises(ValueError):
        gate.main(["--merge", outs[0], outs[0], "--out", str(tmp_path / "bad.json")])
