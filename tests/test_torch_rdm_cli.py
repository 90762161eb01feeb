"""The port's RDM subcommands through cli.main on the CPU at tiny widths:
RDMTrainConfig resolves to reed_tpu's; train-rdm on synthetic batches with
--ckpt-dir (save, then resume) ending in its DDIM smoke sample, and on a
reps.npy + sizes.npy data dir (a width that does not match refused);
eval-molecule --rdm-ref-ckpt samples two-stage from a tiny EDM run with a
reference-layout RDM checkpoint (a width that does not match refused); the
RDM gate's defaults against the TPU record and a tiny gate run."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.train.rdm import RDMTrainConfig as JaxConfig
from reed_tpu_torch import cli
from reed_tpu_torch.models.rdm_mlp import SimpleMLP
from reed_tpu_torch.train.rdm import RDMTrainConfig

torch.set_num_threads(1)
REPO = os.path.join(os.path.dirname(__file__), "..")
TINY_RDM = ["--set", "channels=16", "--set", "model_channels=32", "--set",
            "bottleneck_channels=32", "--set", "num_res_blocks=2", "--set", "time_embed_dim=16",
            "--set", "max_nodes=16", "--device", "cpu"]
TINY_EDM = ["--set", "hidden_nf=32", "--set", "n_layers=2", "--set", "rep_nf=16",
            "--set", "max_nodes=9", "--device", "cpu"]


def _log_steps(text):
    return [int(line.split("]")[0].split()[1]) for line in text.splitlines()
            if line.startswith("[step ")]


def test_config_resolves_as_in_reed_tpu():
    ours = dataclasses.asdict(RDMTrainConfig())
    ref = dataclasses.asdict(JaxConfig())
    ours["mesh"], ref["mesh"] = dataclasses.asdict(JaxMesh()), dataclasses.asdict(JaxMesh())
    assert ours == ref
    cfg = RDMTrainConfig()
    assert (cfg.channels, cfg.model_channels, cfg.bottleneck_channels, cfg.num_res_blocks,
            cfg.batch_size, cfg.optim.weight_decay, cfg.optim.schedule) == (
        256, 1536, 1536, 18, 128, 0.005, "cosine")


def test_train_rdm_synthetic_resume(tmp_path, capsys):
    run = str(tmp_path / "run")
    argv = ["train-rdm", "--synthetic", "--steps", "2", "--batch-size", "4", "--log-every",
            "1", "--ckpt-dir", run, "--ckpt-every", "2", *TINY_RDM]
    cli.main(argv)
    out = capsys.readouterr().out
    assert _log_steps(out) == [1, 2] and "reps/s" in out
    assert "sampled reps: (3, 16) finite: True" in out
    assert {"2.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(run))
    state = cli.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and state.step == 4


def test_train_rdm_data_dir(tmp_path, capsys):
    r = np.random.default_rng(0)
    np.save(tmp_path / "reps.npy", r.standard_normal((20, 16)).astype(np.float32))
    np.save(tmp_path / "sizes.npy", r.integers(5, 15, 20))
    state = cli.main(["train-rdm", "--data-dir", str(tmp_path), "--steps", "6",
                      "--batch-size", "8", "--log-every", "3", *TINY_RDM])
    out = capsys.readouterr().out
    assert "loaded 20 reps" in out and _log_steps(out) == [3, 6] and state.step == 6
    np.save(tmp_path / "reps.npy", r.standard_normal((20, 12)).astype(np.float32))
    with pytest.raises(ValueError, match="width 12"):
        cli.main(["train-rdm", "--data-dir", str(tmp_path), "--steps", "1", *TINY_RDM])


def _reference_rdm(path, channels=16, max_nodes=9):
    """A reference-layout LatentDiffusion checkpoint over `channels`-d reps."""
    model = SimpleMLP(in_channels=channels, out_channels=channels, model_channels=24,
                      bottleneck_channels=24, time_embed_dim=8, num_res_blocks=2,
                      num_classes=max_nodes, context_channels=channels)
    model.initialize_weights(torch.Generator().manual_seed(0))
    sd = {f"model.diffusion_model.{k}": v + 0.05 for k, v in model.state_dict().items()
          if not k.startswith("cond_stage_model.")}
    sd["cond_stage_model.embedding.weight"] = model.state_dict()[
        "cond_stage_model.embedding.weight"][:max_nodes]
    torch.save({"state_dict": sd}, path)


def test_eval_molecule_with_rdm_ref_ckpt(tmp_path, capsys):
    run = str(tmp_path / "run")
    cli.main(["train-molecule-edm", "--synthetic", "--steps", "1", "--batch-size", "2",
              "--ckpt-dir", run, "--ckpt-every", "1", *TINY_EDM])
    rdm = str(tmp_path / "rdm.ckpt")
    _reference_rdm(rdm)
    capsys.readouterr()
    out = cli.main(["eval-molecule", "--ckpt-dir", run, "--rdm-ref-ckpt", rdm, "--num-steps",
                    "3", "--batch-size", "4", "--n-replicates", "1", *TINY_EDM])
    text = capsys.readouterr().out
    assert "DDIM rep sampler from the reference RDM" in text and "rep sampling of 4" in text
    assert set(out) == {"mean", "std", "all"} and "validity" in out["mean"]
    _reference_rdm(rdm, channels=12)
    with pytest.raises(ValueError, match="width 12"):
        cli.main(["eval-molecule", "--ckpt-dir", run, "--rdm-ref-ckpt", rdm, "--num-steps",
                  "3", "--batch-size", "4", "--n-replicates", "1", *TINY_EDM])


def test_gate_defaults_are_the_tpu_record_and_tiny_runs(tmp_path):
    from reed_tpu_torch.tools import convergence_rdm as gate

    with open(os.path.join(REPO, "CONVERGENCE_RDM.json")) as f:
        record = json.load(f)
    rec = record["config"]
    cfg = gate.gate_config()
    assert (cfg.batch_size, cfg.channels, cfg.model_channels, cfg.num_res_blocks,
            cfg.optim.lr) == (rec["batch_size"], rec["channels"], rec["model_channels"],
                              rec["blocks"], rec["lr"])
    assert gate.STEPS == record["steps"] and (gate.ACC_BAR, gate.ERR_BAR) == (0.95, 0.5)
    assert cfg.optim.grad_clip == 1.0 and cfg.curriculum.ema_decay == 0.995
    result = gate.main(["--device", "cpu", "--steps", "3", "--batch-size", "8",
                        "--channels", "8", "--model-channels", "16", "--blocks", "1",
                        "--ddim-steps", "3", "--n-eval", "8", "--seeds", "0", "1",
                        "--out", str(tmp_path / "rdm.json")])
    assert (tmp_path / "rdm.json").exists() and result["seeds"] == [0, 1]
    assert not result["pass"]   # two seeds are no verdict
    assert json.load(open(tmp_path / "rdm.json"))["rule"].startswith("median over seeds")
