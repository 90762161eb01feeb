"""reed_tpu_torch's data-parallel training and generation over two gloo
ranks on the CPU (tests/torch_dp.py, one spawn for the file), against one
process on the same global batch.

- Each trainer (image with plain attention, protein, SemlaFlow, EDM and
  EFM, RDM, property and linear probe, MultiFlow) at a tiny width, two
  steps: every metric, every gradient the update saw and every parameter
  after the steps within 1e-5 of its largest magnitude, on both ranks. A
  rank that used its own draws, its own host batch or its local gradient
  would miss.
- The protein losses, normalised by counts over the batch (trap 2 of the
  port's data parallelism): on a global batch of 4 whose rank-0 half holds
  2.3x the masked tokens of rank 1's, with the AF3 alignment and repr_norm
  on, the 2-rank gradient matches reed_tpu's single-device gradient at the
  protein parity tolerance, while the mean of the two ranks' local-loss
  gradients misses it.
- A checkpoint that rank 0 alone wrote at step 2, resumed on both ranks,
  equals 4 straight steps; train-protein --distributed through the CLI.
- Sharded generate_samples equals one process's samples; rank 0 writes
  the npz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp
from reed_tpu.core.config import CurriculumConfig as JaxCurriculum
from reed_tpu.core.config import MeshConfig as JaxMesh
from reed_tpu.core.trainer import combine_losses as jax_combine_losses
from reed_tpu.diffusion.discrete import corrupt_batch as jax_corrupt_batch
from reed_tpu.train.protein import ProteinTrainConfig as JaxConfig
from reed_tpu.train.protein import ProteinTrainer as JaxTrainer
from reed_tpu.train.protein import make_loss_fn as jax_make_loss_fn
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax
from reed_tpu_torch.eval.fid import generate_samples
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.train.protein import make_loss_fn
from torch_parity import fmif_batch, fmif_random_params

torch.set_num_threads(1)

REL = 1e-5          # 2 ranks against 1 process, of each quantity's largest magnitude
GRAD_TOL = 5e-4     # the protein parity tolerance (tests/test_torch_protein_train.py)
GEN_REL = 1e-5


def _trap_batch():
    """A global batch of 4 x 16: rows 0-1 (rank 0) whole, rows 2-3 (rank 1)
    with 7 valid residues each, so rank 0 holds 32 masked tokens to 14. (A
    row keeps more valid residues than the 6 neighbours: where a valid
    residue must take a padded neighbour, the padded ones tie and
    torch.topk and jax.lax.top_k may pick different ones, ops/graph.py.)"""
    batch = fmif_batch(batch=4, length=16, seed=3)
    batch["mask"][2:, 7:] = 0.0
    batch["X"][2:, 7:] = 0.0
    batch["S"][2:, 7:] = 20
    batch["residue_idx"][2:, 7:] = -100
    rng = np.random.default_rng(13)
    for key, shape in (("repr_single", (16, 8)), ("repr_pair", (16, 16, 4)),
                       ("repr_structure", (16, 8))):
        batch[key] = rng.standard_normal((4,) + shape).astype(np.float32)
    return batch


def _jax_trap(batch):
    """reed_tpu's single-device protein gradient on the whole batch, with
    its corrupted tokens and t: (params, grads by port name, (S_t, t))."""
    cfg = JaxConfig(**torch_dp.TRAP_TINY, mesh=JaxMesh(data=1),
                    curriculum=JaxCurriculum(proj_coeff=0.2, diffusion_warmup_steps=0))
    assert cfg.load_repr and cfg.repr_norm
    trainer = JaxTrainer(cfg)
    params = fmif_random_params(trainer.model, batch, std=0.1, seed=0)["params"]
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(trainer.train_rng, 0)
    noisy = jax_corrupt_batch(jax.random.split(step_rng, 4)[0], jbatch, cfg.interpolant)
    curriculum = JaxCurriculum(**{**cfg.curriculum.__dict__, "proj_coeff": cfg.repr_weight})
    loss_fn = jax_make_loss_fn(trainer.model, cfg)
    grads = jax.jit(jax.grad(lambda p: jax_combine_losses(
        loss_fn(p, jbatch, step_rng, 0), 0, curriculum)[0]))(jparams)
    return (state_dict_from_flax(params),
            state_dict_from_flax(jax.tree.map(np.asarray, grads)),
            (np.asarray(noisy["S_t"]), np.asarray(noisy["t"])))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Both ranks' results, and reed_tpu's trap gradient with its inputs."""
    out = tmp_path_factory.mktemp("data_parallel")
    batch = _trap_batch()
    params, jax_grads, noisy = _jax_trap(batch)
    inputs = {"params": params, "batch": batch, "noisy": noisy}
    torch.save(inputs, out / "trap_inputs.pt")
    torch_dp.spawn(out, "data_parallel")
    ranks = [torch.load(out / f"dp_rank{r}.pt", weights_only=False)
             for r in range(torch_dp.WORLD)]
    return out, ranks, inputs, jax_grads


def _err(a, b):
    """max |a - b| over max |b| (0 where both are 0)."""
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    diff = float((a - b).abs().max())
    return diff / float(b.abs().max()) if diff else 0.0


@pytest.mark.parametrize("case", sorted(torch_dp.CASES))
def test_two_ranks_match_one_process(dp_run, case, monkeypatch):
    """Each quantity against the largest of its kind: a step's metrics
    against its largest metric (a loss near 0, as loss_pair, is a sum of
    O(1) terms whose rounding follows their size, not the sum's), a step's
    gradients against its largest gradient, the parameters against the
    largest parameter. Parameter elements whose gradient is at rounding
    level (below 1e-6 of the step's largest) take Adam's first updates, lr
    * g / (|g| + eps), of up to lr whatever g's digits: they are held to 2
    lr a step."""
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    _, ranks, _, _ = dp_run
    want = torch_dp.run_case(case)
    names = list(want["params"])
    noise = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in want["params"].items()}
    for step, gw in enumerate(want["grads"]):
        top = max(float(g.abs().max()) for g in gw)
        for n, g in zip(names, gw):
            noise[n] |= g.abs() < 1e-6 * top
    top_param = max(float(v.abs().max()) for v in want["params"].values())
    for rank, got in enumerate(r[case] for r in ranks):
        for step, (mg, mw) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(mg) == set(mw)
            top = max(abs(v) for v in mw.values())
            bad = {k: (mg[k], mw[k]) for k in mw if abs(mg[k] - mw[k]) > REL * top}
            assert not bad, (rank, step, bad)
        for step, (gg, gw) in enumerate(zip(got["grads"], want["grads"])):
            assert len(gg) == len(gw) == len(names)
            top = max(float(g.abs().max()) for g in gw)
            errs = {n: float((a - b).abs().max()) / top for n, a, b in zip(names, gg, gw)}
            worst = max(errs, key=errs.get)
            assert errs[worst] <= REL, (rank, step, worst, errs[worst])
        for n, w in want["params"].items():
            diff = (got["params"][n] - w).abs()
            bound = torch.where(noise[n], 2 * 2 * want["lr"], REL * top_param)
            assert bool((diff <= bound).all()), (rank, n, float(diff.max()))


def test_protein_global_counts_match_reed_tpu(dp_run):
    """The 2-rank global gradient is reed_tpu's single-device gradient; the
    mean of each rank's gradient of its local loss is not."""
    _, ranks, inputs, jax_grads = dp_run
    for got in (r["trap"] for r in ranks):
        assert set(got) == set(jax_grads)
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), jax_grads[name].numpy(), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)

    # the naive design: each rank's loss over its rows alone, gradients averaged
    trainer, state = torch_dp.trap_trainer(inputs["params"])
    names, leaves = zip(*state.model.named_parameters())
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
    noisy = tuple(torch.as_tensor(x) for x in inputs["noisy"])
    naive = [torch.zeros_like(p) for p in leaves]
    for rows in (slice(0, 2), slice(2, 4)):
        metrics = make_loss_fn(trainer.cfg)(state.model, {k: v[rows] for k, v in batch.items()},
                                            0, noisy=tuple(x[rows] for x in noisy))
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        naive = [n + (0 if g is None else g) / 2 for n, g in zip(naive, grads)]
    missed = [name for name, g in zip(names, naive)
              if not np.allclose(g.numpy(), jax_grads[name].numpy(), rtol=GRAD_TOL,
                                 atol=GRAD_TOL)]
    assert len(missed) > len(names) // 2, missed


def test_resume_from_a_rank0_checkpoint(dp_run):
    out, ranks, _, _ = dp_run
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["2.pt"]
    assert ranks[0]["resume"]["writes"] == [2] and ranks[1]["resume"]["writes"] == []
    for r in ranks:
        res = r["resume"]
        assert res["step"] == 4 and set(res["resumed"]) == set(res["straight"])
        bad = {k: _err(v, res["straight"][k]) for k, v in res["resumed"].items()
               if _err(v, res["straight"][k]) > REL}
        assert not bad, bad


def test_cli_train_protein_distributed(dp_run):
    """Rank 0 alone writes config.json, metrics.jsonl and the checkpoint;
    both ranks end with the same state."""
    out, ranks, _, _ = dp_run
    files = sorted(p.name for p in (out / "cli").iterdir())
    assert files == ["2.pt", "config.json", "metrics.jsonl"]
    assert len((out / "cli" / "metrics.jsonl").read_text().splitlines()) == 2
    a, b = ranks[0]["cli"], ranks[1]["cli"]
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("cmd", sorted(torch_dp.CLI_TINY))
def test_every_data_parallel_subcommand_runs_distributed(dp_run, cmd):
    """`cmd --distributed` on both ranks: two steps, the ranks' parameters
    equal; generate-image writes its npz once."""
    out, ranks, _, _ = dp_run
    got = [r["cli_all"][cmd] for r in ranks]
    if cmd == "generate-image":
        assert got == [None, None]
        samples = np.load(out / "gen_cli.npz")["arr_0"]
        assert samples.shape == (4, 8, 8, 4) and np.isfinite(samples).all()
        return
    (step0, params0), (step1, params1) = got
    assert step0 == step1 == 2
    assert all(torch.equal(params0[k], params1[k]) for k in params0)


def test_sharded_generation_matches_one_process(dp_run, monkeypatch):
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    out, ranks, _, _ = dp_run
    model = torch_dp.seeded_sit()
    want = generate_samples(lambda x, t, y: model(x, t, y)[0], torch_dp.gen_cfg(),
                            device="cpu")
    assert want.shape == (6, 8, 8, 4) and np.isfinite(want).all()
    for r in ranks:
        assert _err(r["generate"], want) <= GEN_REL
    np.testing.assert_array_equal(np.load(out / "gen.npz")["arr_0"], ranks[0]["generate"])
