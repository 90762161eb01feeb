"""core/checkpoint.py: a run saved after two steps and resumed in a fresh
trainer ends bitwise equal to the uninterrupted run (parameters, EMA,
optimizer moments and count, and the trainer's generator, which draws t,
eps, label drops, dropout and the corruption), for a tiny SiT and a tiny
ProteinMPNN-FMIF on the CPU; max_to_keep, the save interval, and the
CLI's --ckpt-dir resume."""

import os

import numpy as np
import pytest
import torch

from reed_tpu_torch import cli
from reed_tpu_torch.core import stats
from reed_tpu_torch.core.checkpoint import CheckpointManager
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.train.image import ImageTrainConfig, ImageTrainer
from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

torch.set_num_threads(1)

TINY_SIT = dict(depth=2, hidden_size=64, num_heads=4)
IMAGE = dict(model="SiT-T/2", input_size=8, num_classes=10, encoder_depth=1,
             z_dims=(8,), projector_dim=16, batch_size=3, compute_dtype="float32")
PROTEIN = dict(hidden_dim=32, num_encoder_layers=2, num_decoder_layers=2, k_neighbors=6,
               dropout=0.1, single_dim=8, pair_dim=4, structure_dim=8, batch_size=2,
               max_len=16)


@pytest.fixture(autouse=True)
def tiny_sit(monkeypatch):
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", TINY_SIT)


def _trainers():
    from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig

    cur = CurriculumConfig(diffusion_warmup_steps=0, ema_decay=0.9)
    return {
        "image": lambda: ImageTrainer(ImageTrainConfig(
            **IMAGE, optim=OptimConfig(lr=1e-3, grad_clip=1.0, mu_dtype="bfloat16"),
            curriculum=cur), device="cpu"),
        "protein": lambda: ProteinTrainer(ProteinTrainConfig(
            **PROTEIN, optim=OptimConfig(lr=1e-3, grad_clip=1.0, accum_steps=2),
            curriculum=cur), device="cpu"),
    }


def _tensors(state):
    names = [n for n, _ in state.model.named_parameters()]
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    out.update({f"ema {n}": t for n, t in state.ema.items()})
    for kind in ("mu", "nu", "acc"):
        out.update({f"{kind} {n}": t for n, t in zip(names, getattr(state.opt, kind) or [])})
    return out


def _run(trainer, state, batches):
    for b in batches:
        state, _ = trainer.train_step(state, b)
    return state


@pytest.mark.parametrize("domain", ["image", "protein"])
def test_resume_is_bitwise_equal(domain, tmp_path):
    make = _trainers()[domain]
    probe = make()
    batches = [probe.synthetic_batch(torch.Generator().manual_seed(10 + i)) for i in range(4)]

    ta = make()
    full = _run(ta, ta.init_state(), batches)

    tb = make()
    half = _run(tb, tb.init_state(), batches[:2])
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(half, tb.generator) and mgr.latest_step() == 2

    tc = make()
    resumed = tc.init_state()
    mgr.restore(resumed, tc.generator)
    assert resumed.step == 2
    assert resumed.opt.count == half.opt.count and resumed.opt.mini_step == half.opt.mini_step
    resumed = _run(tc, resumed, batches[2:])

    want, got = _tensors(full), _tensors(resumed)
    assert set(want) == set(got)
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    assert not bad, bad[:5]
    assert resumed.step == full.step == 4 and resumed.opt.count == full.opt.count
    assert torch.equal(tc.generator.get_state(), ta.generator.get_state())
    if domain == "image":
        assert resumed.opt.mu[0].dtype == torch.bfloat16

    # without the generator's state the draws differ: the state matters
    td = make()
    other = td.init_state()
    mgr.restore(other)
    other = _run(td, other, batches[2:])
    assert not all(torch.equal(a, b) for a, b in zip(_tensors(other).values(), want.values()))


def test_max_to_keep_interval_and_atomic_names(tmp_path):
    trainer = _trainers()["image"]()
    state = trainer.init_state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=2)
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(0))
    saved = []
    for _ in range(7):
        state, _ = trainer.train_step(state, batch)
        saved.append(mgr.save(state, trainer.generator))
        if state.step == 6:
            ema6 = {k: v.clone() for k, v in state.ema.items()}
    assert saved == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6] and not mgr.save(state)  # step 7: off-interval
    (tmp_path / "8.pt.tmp").write_bytes(b"cut")  # a save cut short is never listed
    assert mgr.latest_step() == 6
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)
    ema = mgr.load_ema()
    assert set(ema) == set(ema6) and all(torch.equal(ema[k], ema6[k]) for k in ema)


def test_restore_refuses_another_shape(tmp_path):
    trainer = _trainers()["protein"]()
    state = trainer.init_state()
    state.step = 1
    CheckpointManager(str(tmp_path)).save(state, trainer.generator)
    other = ProteinTrainer(ProteinTrainConfig(**{**PROTEIN, "hidden_dim": 16}),
                           device="cpu").init_state()
    with pytest.raises(RuntimeError):
        CheckpointManager(str(tmp_path)).restore(other)


def test_cli_resumes_from_latest_checkpoint(tmp_path, capsys):
    """train-protein --ckpt-dir --ckpt-every: 4 steps write 2.pt, 4.pt, the
    config snapshot and metrics.jsonl; a second call resumes at step 4 and
    runs 2 more; eval-protein --ckpt-dir samples from the EMA."""
    args = ["train-protein", "--device", "cpu", "--synthetic", "--log-every", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            *[f"--set={k}={v}" for k, v in PROTEIN.items() if k != "dropout"]]
    assert cli.main(args + ["--steps", "4"]).step == 4
    assert {"2.pt", "4.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(tmp_path))
    state = cli.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and state.step == 6
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [int(line.split(",")[0].split(":")[1]) for line in lines] == [2, 4, 6]

    cli.main(["eval-protein", "--device", "cpu", "--ckpt-dir", str(tmp_path),
              "--length", "12", "--num-steps", "4", "--batch-size", "2",
              *[f"--set={k}={v}" for k, v in PROTEIN.items() if k not in ("dropout",
                                                                         "batch_size")]])
    assert "loaded EMA weights of step 6" in capsys.readouterr().out


def test_stats_match_reed_tpu():
    """core/stats.py against reed_tpu's on one process."""
    from reed_tpu.core import stats as jax_stats

    rng = np.random.default_rng(0)
    values = [rng.standard_normal(n) for n in (3, 1, 5)]
    for mod in (stats, jax_stats):
        mod.reset()
    collectors = (stats.Collector(), jax_stats.Collector())
    for v in values[:2]:
        stats.report("loss", torch.from_numpy(v))
        jax_stats.report("loss", v)
    stats.report0("acc", values[2])
    jax_stats.report0("acc", values[2])
    for c in collectors:
        c.update(cross_process=True)
    mine, theirs = (c.as_dict() for c in collectors)
    assert set(mine) == set(theirs) == {"loss", "acc"}
    for name in mine:
        assert mine[name] == pytest.approx(theirs[name], rel=1e-12)
    stats.report("loss", values[2])
    collectors[0].update()
    assert collectors[0].num("loss") == 5 and collectors[0].num("acc") == 0
    assert collectors[0].mean("loss") == pytest.approx(values[2].mean())
    assert np.isnan(collectors[0].mean("missing")) and collectors[0].std("missing") == 0.0
