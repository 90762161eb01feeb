"""Data-parallel runs of reed_tpu_torch for the tests: gloo ranks spawned as
subprocesses that meet through a FileStore (no TCP port), and the tiny
trainer cases that tests/test_torch_data_parallel.py holds against one
process, tests/test_torch_fsdp.py at fsdp=2 against data=2,
tests/test_torch_fsdp_mesh.py at data=2 x fsdp=2 against one process,
tests/test_torch_remat.py under SiT remat,
tests/test_torch_tensor_parallel.py on SiT's tensor and seq axes and
tests/test_torch_protein_tensor_parallel.py on ProteinMPNN's tensor axis
(`settings` sets their mesh, config fields and optimizer).

    python tests/torch_dp.py JOB DIR

runs JOB as one rank (RANK, WORLD_SIZE and LOCAL_RANK from the environment,
as torchrun sets them) and writes its results under DIR; `spawn` starts
the ranks and waits for them. This module imports no JAX: the ranks import
it as a script.
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
TINY_SIT = dict(depth=2, hidden_size=64, num_heads=4)


def spawn(out_dir, job, world=WORLD, timeout=600):
    """Run `job` as `world` gloo ranks writing under `out_dir`; returns each
    rank's output and raises with all of it when a rank fails (a rank left
    waiting in a collective is killed at `timeout` seconds)."""
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, job, str(out_dir)], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"--- rank {r} (exit {p.returncode})\n{o}"
                                       for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def register_tiny_sit():
    """The tiny SiT size 'SiT-T' in the port's size table (a rank's own)."""
    from reed_tpu_torch.models import sit

    sit._SIZES["SiT-T"] = TINY_SIT


# --- the trainer cases: each builds a trainer (on the process group where
# there is one) and its two steps' batches, this rank's rows of them ------

# what `configured` sets on every case's config: the mesh (None: the
# case's own), other top-level fields, and OptimConfig fields over the
# case's own
SETTINGS = {"mesh": None, "fields": {}, "optim": {}}
# the fsdp min size of the tests: the tiny models' matrices shard, their
# biases, norms and smallest tables stay replicated
TINY_MIN_SIZE = 256


def fsdp_mesh(fsdp=WORLD, data=None):
    from reed_tpu_torch.core.config import MeshConfig

    return MeshConfig(data=data, fsdp=fsdp, fsdp_min_size=TINY_MIN_SIZE)


@contextlib.contextmanager
def settings(mesh=None, fields=None, **optim):
    """Build the cases inside the block on `mesh` (a MeshConfig), with the
    config fields `fields` (remat=True, ...) and the OptimConfig fields
    `optim` (grad_clip=None, accum_steps=2, ...)."""
    saved = dict(SETTINGS)
    SETTINGS.update(mesh=mesh, fields=dict(fields or {}), optim=optim)
    try:
        yield
    finally:
        SETTINGS.update(saved)


def configured(cfg):
    """A case's config with SETTINGS applied."""
    from dataclasses import replace

    if SETTINGS["mesh"] is not None:
        cfg = replace(cfg, mesh=SETTINGS["mesh"])
    return replace(cfg, optim=replace(cfg.optim, **SETTINGS["optim"]), **SETTINGS["fields"])



def _protein():
    from reed_tpu_torch.core.config import CurriculumConfig
    from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

    cfg = ProteinTrainConfig(hidden_dim=32, num_encoder_layers=2, num_decoder_layers=2,
                             k_neighbors=6, dropout=0.1, augment_eps=0.02, single_dim=8,
                             pair_dim=4, structure_dim=8, batch_size=4, max_len=16,
                             curriculum=CurriculumConfig(proj_coeff=0.2,
                                                         diffusion_warmup_steps=0))
    trainer = ProteinTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _image():
    from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
    from reed_tpu_torch.diffusion.continuous import FlowMatchingLossConfig
    from reed_tpu_torch.train.image import ImageTrainConfig, ImageTrainer

    register_tiny_sit()
    cfg = ImageTrainConfig(model="SiT-T/2", input_size=8, num_classes=10, encoder_depth=1,
                           encoder_depth_text=2, z_dims=(8, 6), z_types=("i", "t"),
                           projector_dim=32, class_dropout_prob=0.5,
                           compute_dtype="float32", attn_impl="xla", batch_size=4,
                           loss=FlowMatchingLossConfig(enc_names=("dinov2", "qwen"),
                                                       loss_weights=(1.0, 0.5)),
                           optim=OptimConfig(lr=1e-3, grad_clip=1.0),
                           curriculum=CurriculumConfig(proj_coeff=0.5,
                                                       diffusion_warmup_steps=0))
    trainer = ImageTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _semla():
    from reed_tpu_torch.parallel.mesh import local_batch
    from reed_tpu_torch.train.molecule_semla import (SemlaTrainConfig, SemlaTrainer,
                                                     batch_to_device)

    cfg = SemlaTrainConfig(d_model=32, n_layers=3, n_coord_sets=4, d_message=16,
                           d_message_hidden=16, d_edge=8, n_attn_heads=4, size_emb=8,
                           d_rep=16, batch_size=4)
    trainer = SemlaTrainer(configured(cfg), device="cpu")
    return trainer, [batch_to_device(local_batch(trainer.dp, trainer.example_batch(4, 8, seed=i)),
                                     "cpu") for i in range(2)]


def _edm():
    from reed_tpu_torch.train.molecule_edm import MoleculeEDMConfig, MoleculeEDMTrainer

    cfg = MoleculeEDMConfig(hidden_nf=32, n_layers=2, rep_nf=16, max_nodes=9,
                            augment_rotation=True, batch_size=4)
    trainer = MoleculeEDMTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _edm_fm():
    from reed_tpu_torch.train.molecule_edm import MoleculeEDMConfig, MoleculeEDMTrainer

    cfg = MoleculeEDMConfig(hidden_nf=32, n_layers=2, rep_nf=16, max_nodes=9,
                            probabilistic_model="fm", batch_size=4)
    trainer = MoleculeEDMTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _rdm():
    from reed_tpu_torch.train.rdm import RDMTrainConfig, RDMTrainer

    cfg = RDMTrainConfig(channels=16, model_channels=32, bottleneck_channels=32,
                         num_res_blocks=2, time_embed_dim=16, max_nodes=16, dropout=0.1,
                         batch_size=8)
    trainer = RDMTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _property():
    from reed_tpu_torch.train.property import PropertyTrainConfig, PropertyTrainer

    trainer = PropertyTrainer(configured(PropertyTrainConfig(hidden_nf=16, n_layers=2,
                                                             max_nodes=8, batch_size=4)),
                              device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _linear_probe():
    from reed_tpu_torch.train.property import LinearProbeConfig, LinearProbeTrainer

    trainer = LinearProbeTrainer(configured(LinearProbeConfig(rep_dim=12, batch_size=4)),
                                 device="cpu")
    return trainer, [trainer.synthetic_batch(torch.Generator().manual_seed(10 + i))
                     for i in range(2)]


def _multiflow():
    from dataclasses import replace

    from reed_tpu_torch.train.multiflow import MultiflowTrainConfig, MultiflowTrainer

    base = MultiflowTrainConfig()
    cfg = replace(base, c_s=32, c_z=16, num_blocks=2, max_len=16, batch_size=4,
                  interpolant=replace(base.interpolant, aatypes_interpolant="uniform"))
    trainer = MultiflowTrainer(configured(cfg), device="cpu")
    return trainer, [trainer.synthetic_batch(np.random.default_rng(10 + i))
                     for i in range(2)]


CASES = {"protein": _protein, "image": _image, "semla": _semla, "edm": _edm,
         "edm_fm": _edm_fm, "rdm": _rdm, "property": _property,
         "linear_probe": _linear_probe, "multiflow": _multiflow}


def run_case(name, save_first=None):
    """Two train steps of case `name`: {'metrics': [per step {name: float}],
    'grads': [per step [tensor]], 'params': {name: tensor}, 'lr', 'state':
    the whole EMA, mu, nu and acc, 'resident': {'bytes', 'expected'}}, the
    gradients as the update saw them (whole), in parameter order. With
    `save_first` (a directory) a checkpoint of the state after the first
    step is written there (rank 0 writes; every rank gathers)."""
    from reed_tpu_torch.core.checkpoint import CheckpointManager
    from reed_tpu_torch.core.trainer import capture_gradients

    trainer, batches = CASES[name]()
    state = trainer.init_state()
    metrics = []
    with capture_gradients() as grads:
        for batch in batches:
            state, m = trainer.train_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if save_first is not None and state.step == 1:
                CheckpointManager(save_first, dp=trainer.dp).save(state, trainer.generator)
    return {"metrics": metrics, "grads": grads, "lr": trainer.cfg.optim.lr,
            "params": whole_params(state), "state": whole_state(state),
            "resident": resident(state)}


def whole_params(state):
    """The model's parameters by name, whole (joined over the tensor group
    where the model holds tensor shards: a collective), as copies."""
    params = {k: v.detach() for k, v in state.model.named_parameters()}
    plan = state.opt.plan
    if plan is not None:
        params = plan.join_state_dict(params)
    return {k: v.clone() for k, v in params.items()}


def whole_state(state):
    """The EMA, mu, nu and acc of a TrainState, whole (gathered over the
    fsdp group: a collective), as copies."""
    from reed_tpu_torch.core.checkpoint import whole_state as gather

    whole = gather(state)
    return {"ema": {k: v.clone() for k, v in whole["ema"].items()},
            **{k: None if whole[k] is None else [v.clone() for v in whole[k]]
               for k in ("mu", "nu", "acc")}}


def resident(state):
    """The bytes of the EMA, mu, nu and acc this rank holds, and what the
    ShardPlan reckons for them (its resident elements at each list's
    dtype; every element where there is no plan)."""
    opt, plan = state.opt, state.opt.plan
    lists = [list(state.ema.values()), opt.mu, opt.nu] + ([opt.acc] if opt.acc else [])
    held = sum(t.numel() * t.element_size() for ts in lists for t in ts)
    elements = (plan.resident_elements() if plan is not None
                else sum(p.numel() for p in opt.params))
    return {"bytes": held, "expected": elements * sum(ts[0].element_size() for ts in lists),
            "whole": sum(p.numel() for p in opt.params) * sum(
                ts[0].element_size() for ts in lists)}


# --- the protein traps against reed_tpu: the inputs come from the test ----

TRAP_TINY = dict(hidden_dim=32, num_encoder_layers=2, num_decoder_layers=2, k_neighbors=6,
                 dropout=0.0, single_dim=8, pair_dim=4, structure_dim=8, batch_size=4,
                 max_len=16, fused_messages="off")


def trap_trainer(params):
    """A protein trainer of TRAP_TINY on the CPU with the weights `params` (a
    state_dict), and its state."""
    from reed_tpu_torch.core.config import CurriculumConfig
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.core.train_state import make_optimizer
    from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

    cfg = ProteinTrainConfig(**TRAP_TINY, curriculum=CurriculumConfig(
        proj_coeff=0.2, diffusion_warmup_steps=0))
    trainer = ProteinTrainer(configured(cfg), device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(params)
    state.ema = ema_init(state.model)
    state.opt = make_optimizer(cfg.optim, list(state.model.parameters()))
    return trainer, state


def trap_gradient(inputs):
    """The global gradient of one protein step on this rank's rows of
    inputs['batch'] with inputs['noisy'] injected, by parameter name."""
    from reed_tpu_torch.core.trainer import capture_gradients
    from reed_tpu_torch.parallel.mesh import local_batch

    trainer, state = trap_trainer(inputs["params"])
    batch = local_batch(trainer.dp, {k: torch.as_tensor(v) for k, v in inputs["batch"].items()})
    noisy = local_batch(trainer.dp, tuple(torch.as_tensor(x) for x in inputs["noisy"]))
    with capture_gradients() as grads:
        trainer.train_step(state, batch, noisy=noisy)
    names = [n for n, _ in state.model.named_parameters()]
    return dict(zip(names, grads[0]))


# --- the jobs a rank runs -------------------------------------------------


def _job_mesh(out, dp):
    """The collectives and the draws of parallel/ on this rank."""
    from reed_tpu_torch.core import stats
    from reed_tpu_torch.parallel import draws, mesh

    rng = np.random.default_rng(10 + dp.rank)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((3, 4), (5,), (2, 2, 2))] + [torch.arange(6, dtype=torch.float64)]
    mesh.BUCKET_ELEMENTS = 13  # buckets [12], [5, 8] in f32 and [6] in f64
    for v in np.random.default_rng(dp.rank).standard_normal(3 + dp.rank):
        stats.report("loss", v)
    stats.report0("acc", np.array([0.5, 0.75]))
    collector = stats.Collector()
    collector.update(cross_process=True)
    gen = torch.Generator().manual_seed(3)
    with draws.global_rows(dp):
        drawn = [draws.rand((2, 3), generator=gen), draws.randn((2,), generator=gen),
                 draws.randint(0, 9, (2, 4), generator=gen)]
    torch.save({"grads": grads, "reduced": dp.all_reduce_grads(grads),
                "gathered": dp.gather_rows(torch.full((2, 3), float(dp.rank))),
                "summed": dp.all_sum(torch.tensor([1.0, dp.rank])),
                "stats": collector.as_dict(), "drawn": drawn,
                "metrics": dp.mean_metrics({"a": torch.tensor(float(dp.rank)), "b": 2.0})},
               out / f"mesh_rank{dp.rank}.pt")


def _job_data_parallel(out, dp):
    """Every trainer case, the protein trap gradient, a checkpoint at step 2
    and the resume from it against 4 straight steps, train-protein through
    the CLI, and sharded generation."""
    from reed_tpu_torch import cli
    from reed_tpu_torch.eval.fid import generate_samples

    results = {name: run_case(name) for name in CASES}
    results["trap"] = trap_gradient(torch.load(out / "trap_inputs.pt", weights_only=False))
    results["resume"] = resume(out / "ckpt")
    state = cli.main(["train-protein", "--device", "cpu", "--distributed", "--steps", "2",
                      "--batch-size", "4", "--log-every", "1", "--ckpt-dir", str(out / "cli"),
                      "--ckpt-every", "2", "--set", "max_len=16", "--set", "hidden_dim=32",
                      "--set", "k_neighbors=6"])
    results["cli"] = state_tensors(state)
    register_tiny_sit()
    results["cli_all"] = {}
    for cmd, args in CLI_TINY.items():
        out_args = ["--out", str(out / "gen_cli.npz")] if cmd == "generate-image" else [
            "--steps", "2", "--log-every", "1"]
        state = cli.main([cmd, "--device", "cpu", "--distributed", *args, *out_args])
        results["cli_all"][cmd] = None if state is None else (
            state.step, {k: v.detach().clone() for k, v in state.model.named_parameters()})
    model = seeded_sit()
    results["generate"] = generate_samples(lambda x, t, y: model(x, t, y)[0], gen_cfg(),
                                           device="cpu", out_npz=str(out / "gen.npz"))
    torch.save(results, out / f"dp_rank{dp.rank}.pt")


# every data-parallel subcommand at a tiny width, global batches that two
# ranks split
CLI_TINY = {
    "train-protein": ["--batch-size", "4", "--set", "max_len=16", "--set", "hidden_dim=32"],
    "train-image": ["--model", "SiT-T/2", "--batch-size", "4", "--set", "encoder_depth=1",
                    "--set", "input_size=8", "--set", "num_classes=10",
                    "--set", "projector_dim=16"],
    "train-molecule-semla": ["--batch-size", "4", "--set", "d_model=32", "--set", "n_layers=3",
                             "--set", "n_coord_sets=4", "--set", "d_message=16",
                             "--set", "d_message_hidden=16", "--set", "d_edge=8",
                             "--set", "n_attn_heads=4"],
    "train-molecule-edm": ["--batch-size", "4", "--set", "hidden_nf=32", "--set", "n_layers=2",
                           "--set", "rep_nf=16", "--set", "max_nodes=9"],
    "train-rdm": ["--batch-size", "8", "--set", "channels=16", "--set", "model_channels=32",
                  "--set", "bottleneck_channels=32", "--set", "num_res_blocks=2",
                  "--set", "time_embed_dim=16", "--set", "max_nodes=16"],
    "train-property": ["--batch-size", "4", "--set", "hidden_nf=16", "--set", "n_layers=2",
                       "--set", "max_nodes=8"],
    "train-multiflow": ["--batch-size", "2", "--set", "c_s=32", "--set", "c_z=16",
                        "--set", "num_blocks=2", "--set", "max_len=16"],
    "generate-image": ["--model", "SiT-T/2", "--num-samples", "4", "--batch-size", "4",
                       "--num-steps", "2", "--set", "input_size=8", "--set", "num_classes=10"],
}


def resume(ckpt_dir):
    """The protein case (dropout and coordinate noise on): 4 straight steps,
    and 2 steps saved at step 2 then 2 more from a fresh trainer restored
    from the checkpoint. Returns both states and the steps this rank wrote."""
    from reed_tpu_torch.core import checkpoint

    writes = []
    write = checkpoint.CheckpointManager._write

    def counted(self, state, *rest):
        writes.append(rest[-1])
        return write(self, state, *rest)

    checkpoint.CheckpointManager._write = counted
    try:
        trainer, batches = _protein()
        batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                    for i in range(2)]
        state = trainer.init_state()
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        straight = state_tensors(state)

        trainer, _ = _protein()
        state = trainer.init_state()
        mgr = checkpoint.CheckpointManager(ckpt_dir, save_interval_steps=2, dp=trainer.dp)
        for batch in batches[:2]:
            state, _ = trainer.train_step(state, batch)
        mgr.save(state, trainer.generator)

        trainer, _ = _protein()
        state = trainer.init_state()
        mgr = checkpoint.CheckpointManager(ckpt_dir, save_interval_steps=2, dp=trainer.dp)
        mgr.restore(state, trainer.generator)
        for batch in batches[2:]:
            state, _ = trainer.train_step(state, batch)
    finally:
        checkpoint.CheckpointManager._write = write
    return {"straight": straight, "resumed": state_tensors(state), "step": state.step,
            "writes": writes}


def state_tensors(state):
    """The parameters, EMA and Adam moments of a TrainState, by name, whole
    (gathered over the fsdp group: a collective)."""
    whole = whole_state(state)
    out = {f"param/{k}": v for k, v in whole_params(state).items()}
    out.update({f"ema/{k}": v for k, v in whole["ema"].items()})
    out.update({f"mu/{i}": v for i, v in enumerate(whole["mu"])})
    out.update({f"nu/{i}": v for i, v in enumerate(whole["nu"])})
    return out


def seeded_sit(parallel=None):
    """A tiny SiT-T/2 with every weight ~ N(0, 0.05) from seed 0, so that
    attention and the adaLN branches reach the velocity; split over the seq
    and tensor axes of `parallel` (a DataParallel) where given."""
    from reed_tpu_torch.models.sit import create_sit
    from reed_tpu_torch.parallel.mesh import SIT_TP_RULES, shard_state_dict

    register_tiny_sit()

    def create(mesh):
        return create_sit("SiT-T/2", input_size=8, in_channels=4, num_classes=10,
                          encoder_depth=1, z_dims=(8,), projector_dim=16,
                          attn_impl="reference", parallel=mesh).eval()

    model = create(None)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    if parallel is not None:
        whole, model = model, create(parallel)
        model.load_state_dict(shard_state_dict(whole.state_dict(), parallel, SIT_TP_RULES))
    return model


def gen_cfg():
    """Two batches of 4 (6 samples) of 4 SDE steps with CFG in a window."""
    from reed_tpu_torch.eval.fid import FIDGenConfig

    return FIDGenConfig(num_samples=6, batch_size=4, num_classes=10, latent_size=8,
                        latent_channels=4, mode="sde", num_steps=4, cfg_scale=2.0,
                        guidance_high=0.7, seed=5)


# the cases whose configs clip (grad_clip 1.0: bench.py's image step and
# the protein and SemlaFlow defaults) and the clip each runs at so that it
# acts on the first step (the tiny image case's norms are 0.82 and 0.90)
CLIPPED = {"image": 0.5, "protein": 1.0, "semla": 1.0}


def _job_fsdp(out, dp):
    """On two ranks: every case at data=2 and at fsdp=2 without the clip,
    and the clipped cases with it; the fsdp collectives on seeded rows; the
    resident state with accum_steps=2 and a bf16 mu; the
    checkpoints across sizes; every train-* subcommand and generate-image
    with --fsdp 2 through the CLI."""
    from reed_tpu_torch import cli

    results = {}
    for name in CASES:
        with settings(grad_clip=None):
            results["data", name] = run_case(name)
        with settings(fsdp_mesh(), grad_clip=None):
            results["fsdp", name] = run_case(name)
    for name, clip in CLIPPED.items():
        with settings(grad_clip=clip):
            results["data_clip", name] = run_case(name)
        with settings(fsdp_mesh(), grad_clip=clip):
            results["fsdp_clip", name] = run_case(name)
    results["collectives"] = collectives()
    with settings(fsdp_mesh(), accum_steps=2, mu_dtype="bfloat16"):
        results["fsdp_accum", "image"] = run_case("image")
    with settings(fsdp_mesh()):
        results["resume"] = resume_across(out)
    state = cli.main(["train-protein", "--device", "cpu", "--distributed", "--fsdp", "2",
                      "--steps", "2", "--batch-size", "4", "--log-every", "1", "--ckpt-dir",
                      str(out / "cli"), "--ckpt-every", "2", "--set", "max_len=16",
                      "--set", "hidden_dim=32", "--set", "k_neighbors=6",
                      "--set", f"mesh.fsdp_min_size={TINY_MIN_SIZE}"])
    results["cli"] = state_tensors(state)
    results["cli_sharded"] = sum(state.opt.plan.sharded)
    register_tiny_sit()
    results["cli_all"] = {}
    for cmd, args in CLI_TINY.items():
        out_args = ["--out", str(out / "gen_cli.npz")] if cmd == "generate-image" else [
            "--steps", "2", "--log-every", "1", "--set", f"mesh.fsdp_min_size={TINY_MIN_SIZE}"]
        state = cli.main([cmd, "--device", "cpu", "--distributed", "--fsdp", "2", *args,
                          *out_args])
        results["cli_all"][cmd] = None if state is None else (
            state.step, sum(state.opt.plan.sharded),
            {k: v.detach().clone() for k, v in state.model.named_parameters()})
    torch.save(results, out / f"fsdp_rank{dp.rank}.pt")


def collectives():
    """DataParallel.reduce_scatter and all_gather over an fsdp group of
    every rank, per dtype: this rank's seeded [F, S] buffer and [S] row
    and what the two collectives returned."""
    from reed_tpu_torch.parallel.mesh import DataParallel

    dp = DataParallel(fsdp=torch.distributed.get_world_size())
    gen = torch.Generator().manual_seed(dp.rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(dp.fsdp, 37, generator=gen).to(dtype)
        row = torch.randn(37, generator=gen).to(dtype)
        out[dtype] = {"buf": buf.clone(), "row": row, "mine": dp.reduce_scatter(buf),
                      "rows": dp.all_gather(row)}
    return out


def resume_across(out, case="protein", here="ckpt_here", one="ckpt_one"):
    """Case `case` on this mesh: a checkpoint written here at step 2 (under
    out/`here`), and the one-process checkpoint of step 2 the test wrote
    (out/`one`) restored here, its whole state read back and 2 more steps
    taken. Returns the whole state at step 2 and after the resumed steps."""
    from reed_tpu_torch.core import checkpoint

    trainer, batches = CASES[case]()
    batches += [trainer.synthetic_batch(torch.Generator().manual_seed(12 + i))
                for i in range(2)]
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(out / here, save_interval_steps=2, dp=trainer.dp)
    for batch in batches[:2]:
        state, _ = trainer.train_step(state, batch)
    mgr.save(state, trainer.generator)
    saved = state_tensors(state)

    trainer, _ = CASES[case]()
    state = trainer.init_state()
    mgr = checkpoint.CheckpointManager(out / one, save_interval_steps=2, dp=trainer.dp)
    mgr.restore(state, trainer.generator)
    restored = state_tensors(state)
    for batch in batches[2:]:
        state, _ = trainer.train_step(state, batch)
    plan = state.opt.plan
    return {"saved": saved, "restored": restored, "resumed": state_tensors(state),
            "step": state.step, "sharded": 0 if plan is None else sum(plan.sharded)}


def _job_fsdp_mesh(out, dp):
    """On four ranks, data=2 x fsdp=2: the image and protein cases, and the
    protein case with accum_steps=2 and a bf16 mu."""
    results = {}
    with settings(fsdp_mesh(2, 2)):
        for name in ("image", "protein"):
            results[name] = run_case(name)
    with settings(fsdp_mesh(2, 2), accum_steps=2, mu_dtype="bfloat16"):
        results["protein_accum"] = run_case("protein")
    results["groups"] = (dp.rank, dp.world, trainer_axes())
    torch.save(results, out / f"fsdp_mesh_rank{dp.rank}.pt")


def trainer_axes():
    """(data, fsdp, fsdp_index, the global ranks of its fsdp group, those of
    its data group) of a data=2 x fsdp=2 trainer."""
    from torch.distributed import get_process_group_ranks

    with settings(fsdp_mesh(2, 2)):
        trainer, _ = _protein()
    d = trainer.dp
    return (d.data, d.fsdp, d.fsdp_index, get_process_group_ranks(d.fsdp_group),
            get_process_group_ranks(d.data_group))


# the remat settings the tests run on ranks, and the meshes
REMATS = (False, True, "dots")


def _job_remat(out, dp):
    """On two ranks: the image case (f32 and bf16) under each remat setting
    at data=2 and at fsdp=2."""
    results = {}
    for mesh_name, mesh in (("data", None), ("fsdp", fsdp_mesh())):
        for dtype in ("float32", "bfloat16"):
            for remat in REMATS:
                with settings(mesh, fields={"remat": remat, "compute_dtype": dtype},
                              grad_clip=None):
                    results[mesh_name, dtype, remat] = run_case("image")
    torch.save(results, out / f"remat_rank{dp.rank}.pt")


# --- SiT's tensor and seq axes ---------------------------------------------

# the image case at 64 tokens (input 16, patch 2): four heads, 64 hidden
TP_FIELDS = {"input_size": 16}
# the meshes of the two-rank and four-rank jobs
TP_MESHES = {"tensor": dict(tensor=2), "seq": dict(seq=2)}
TP_MESHES_4 = {"data_tensor": dict(data=2, tensor=2), "seq_tensor": dict(seq=2, tensor=2),
               "fsdp_tensor": dict(fsdp=2, tensor=2)}
# the CLI runs of the two jobs: train-image and generate-image at tiny widths
TP_CLI = {"tensor": ["--tp", "2"], "seq": ["--sp", "2"]}
TP_CLI_4 = {"data_tensor": ["--dp", "2", "--tp", "2"],
            "fsdp_seq": ["--fsdp", "2", "--sp", "2"]}
# generate-image's settings beside CLI_TINY's that load train-image's
# checkpoint at 64 tokens
TP_GENERATE = ["--set", "input_size=16", "--set", "encoder_depth=1",
               "--set", "projector_dim=16"]


def tp_mesh(**axes):
    from reed_tpu_torch.core.config import MeshConfig

    return MeshConfig(fsdp_min_size=TINY_MIN_SIZE, **axes)


def tp_cli(flags, out, tag):
    """train-image (2 steps, a checkpoint at step 2 under out/cli_{tag}) and
    generate-image from its EMA with the mesh flags `flags` through the CLI,
    at 64 tokens: the trained step and whole parameters."""
    from reed_tpu_torch import cli

    register_tiny_sit()
    ckpt = ["--ckpt-dir", str(out / f"cli_{tag}")]
    state = cli.main(["train-image", "--device", "cpu", "--distributed", *flags,
                      *CLI_TINY["train-image"], "--steps", "2", "--log-every", "1",
                      "--set", "input_size=16", *ckpt, "--ckpt-every", "2",
                      "--set", f"mesh.fsdp_min_size={TINY_MIN_SIZE}"])
    cli.main(["generate-image", "--device", "cpu", "--distributed", *flags,
              *CLI_TINY["generate-image"], *TP_GENERATE, *ckpt,
              "--out", str(out / f"gen_cli_{tag}.npz")])
    return state.step, whole_params(state)


def jax_parity_step(inputs, axes):
    """One image step on this mesh from the weights, batch and draws (t, eps,
    label drops) of reed_tpu's step in `inputs`: its metrics, the whole
    gradients by name, and the whole parameters and EMA after it."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.core.train_state import make_optimizer
    from reed_tpu_torch.core.trainer import capture_gradients
    from reed_tpu_torch.parallel.mesh import SIT_TP_RULES, local_batch, shard_state_dict

    with settings(tp_mesh(**axes), fields=TP_FIELDS):
        trainer, _ = _image()
    state = trainer.init_state()
    plan = state.opt.plan
    state.model.load_state_dict(shard_state_dict(inputs["params"], trainer.dp, SIT_TP_RULES))
    state.ema = ema_init(state.model, plan=plan)
    state.opt = make_optimizer(trainer.cfg.optim, list(state.model.parameters()), plan)
    batch = local_batch(trainer.dp, {"x": torch.as_tensor(inputs["batch"]["x"]),
                                     "y": torch.as_tensor(inputs["batch"]["y"]).long(),
                                     "zs": [torch.as_tensor(z) for z in inputs["batch"]["zs"]]})
    t, eps, drop = local_batch(trainer.dp, tuple(torch.as_tensor(a) for a in inputs["draws"]))
    with capture_gradients() as grads:
        state, metrics = trainer.train_step(state, batch, t=t, eps=eps, drop=drop)
    names = [n for n, _ in state.model.named_parameters()]
    whole = whole_state(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(zip(names, grads[0])), "params": whole_params(state),
            "ema": whole["ema"]}


def _job_tensor_parallel(out, dp):
    """On two ranks, at tensor=2 and at seq=2: the image case (64 tokens, 'i'
    and 't' projectors at split depths), with the clip acting, under remat
    True and 'dots'; the checkpoints across sizes; sharded generation;
    reed_tpu's step on the same weights and draws; train-image and
    generate-image through the CLI; and this rank's place on the mesh."""
    from reed_tpu_torch.eval.fid import generate_samples
    from reed_tpu_torch.parallel.mesh import SIT_AXES, data_parallel

    results = {}
    inputs = torch.load(out / "jax_inputs.pt", weights_only=False)
    for name, axes in TP_MESHES.items():
        mesh = tp_mesh(**axes)
        for remat in (False, True, "dots"):
            with settings(mesh, fields=dict(TP_FIELDS, remat=remat)):
                results[name, remat] = run_case("image")
        with settings(mesh, fields=TP_FIELDS, grad_clip=CLIPPED["image"]):
            results[name, "clip"] = run_case("image")
        with settings(mesh, fields=TP_FIELDS):
            results[name, "resume"] = resume_across(out, "image", f"ckpt_{name}",
                                                    "ckpt_one_image")
        parallel = data_parallel(mesh, axes=SIT_AXES)
        model = seeded_sit(parallel)
        results[name, "generate"] = generate_samples(
            lambda x, t, y: model(x, t, y)[0], gen_cfg(), device="cpu", mesh=mesh)
        results[name, "jax"] = jax_parity_step(inputs[name], axes)
        results[name, "cli"] = tp_cli(TP_CLI[name], out, name)
        results[name, "axes"] = (parallel.process_rank, parallel.rank, parallel.world,
                                 parallel.seq_index, parallel.tensor_index)
    torch.save(results, out / f"tp_rank{dp.process_rank}.pt")


def _job_tensor_parallel_mesh(out, dp):
    """On four ranks: the image case at data=2 x tensor=2, seq=2 x tensor=2
    and fsdp=2 x tensor=2; train-image and generate-image through the CLI
    at --dp 2 --tp 2 and --fsdp 2 --sp 2; each rank's groups."""
    from torch.distributed import get_process_group_ranks

    from reed_tpu_torch.parallel.mesh import GROUP_AXES, SIT_AXES, data_parallel

    results = {}
    for name, axes in TP_MESHES_4.items():
        with settings(tp_mesh(**axes), fields=TP_FIELDS):
            results[name] = run_case("image")
        groups = {kind: getattr(data_parallel(tp_mesh(**axes), axes=SIT_AXES),
                                f"{kind}_group") for kind in GROUP_AXES}
        results[name, "groups"] = {kind: None if g is None else get_process_group_ranks(g)
                                   for kind, g in groups.items()}
    for name, flags in TP_CLI_4.items():
        results[name, "cli"] = tp_cli(flags, out, name)
    torch.save(results, out / f"tp_mesh_rank{dp.process_rank}.pt")


# --- ProteinMPNN's tensor axis ----------------------------------------------

# the protein case at tensor=2: the fused chain (its plain version on the
# CPU) and the unfused one ('off'), each without and with dropout (the case
# has dropout 0.1 and coordinate noise 0.02)
PTP_VARIANTS = {("fused", 0.0): {"dropout": 0.0}, ("fused", 0.1): {},
                ("off", 0.0): {"dropout": 0.0, "fused_messages": "off"},
                ("off", 0.1): {"fused_messages": "off"}}
PTP_MESHES_4 = {"data_tensor": dict(data=2, tensor=2), "fsdp_tensor": dict(fsdp=2, tensor=2)}
# the reed_tpu step's configuration (TRAP_TINY with target noise on)
PTP_JAX_FIELDS = {"repr_noise": 0.3}
# train-protein through the CLI at tiny widths (2 + 2 layers, K 6)
PTP_CLI = [*CLI_TINY["train-protein"], "--set", "k_neighbors=6",
           "--set", "num_encoder_layers=2", "--set", "num_decoder_layers=2",
           "--steps", "2", "--log-every", "1"]


def ptp_first(key):
    """The directory of the checkpoint a mesh run of PTP_VARIANTS key (or
    PTP_MESHES_4 name) `key` writes after its first step."""
    return "ptp_first_" + ("_".join(map(str, key)) if isinstance(key, tuple) else key)


def protein_jax_parity_step(inputs, fused_messages):
    """One TRAP_TINY protein step at tensor=2 from the weights, batch and
    draws (S_t, t, target noise) of reed_tpu's step in `inputs`: its
    metrics, the whole gradients by name, and the whole parameters and EMA
    after it."""
    from reed_tpu_torch.core.config import CurriculumConfig
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.core.train_state import make_optimizer
    from reed_tpu_torch.core.trainer import capture_gradients
    from reed_tpu_torch.parallel.mesh import PMPNN_TP_RULES, local_batch, shard_state_dict
    from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

    cfg = ProteinTrainConfig(**dict(TRAP_TINY, fused_messages=fused_messages),
                             **PTP_JAX_FIELDS, mesh=tp_mesh(tensor=2),
                             curriculum=CurriculumConfig(proj_coeff=0.2,
                                                         diffusion_warmup_steps=0))
    trainer = ProteinTrainer(cfg, device="cpu")
    state = trainer.init_state()
    plan = state.opt.plan
    state.model.load_state_dict(shard_state_dict(inputs["params"], trainer.dp, PMPNN_TP_RULES))
    state.ema = ema_init(state.model, plan=plan)
    state.opt = make_optimizer(cfg.optim, list(state.model.parameters()), plan)
    batch = local_batch(trainer.dp, {k: torch.as_tensor(v) for k, v in inputs["batch"].items()})
    noisy = local_batch(trainer.dp, tuple(torch.as_tensor(x) for x in inputs["noisy"]))
    noise = local_batch(trainer.dp, [torch.as_tensor(x) for x in inputs["repr_noise"]])
    with capture_gradients() as grads:
        state, metrics = trainer.train_step(state, batch, noisy=noisy, repr_noise=noise)
    names = [n for n, _ in state.model.named_parameters()]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(zip(names, grads[0])), "params": whole_params(state),
            "ema": whole_state(state)["ema"]}


def protein_cli(out, flags, tag):
    """train-protein through the CLI (2 steps, a checkpoint at step 2 under
    out/ptp_cli_{tag}) with the mesh flags `flags`: the trained step and
    whole state."""
    from reed_tpu_torch import cli

    state = cli.main(["train-protein", "--device", "cpu", *flags, *PTP_CLI,
                      "--ckpt-dir", str(out / f"ptp_cli_{tag}"), "--ckpt-every", "2"])
    return state.step, state_tensors(state)


def _job_protein_tensor_parallel(out, dp):
    """On two ranks at tensor=2: the protein case fused and unfused, without
    and with dropout; the checkpoints across tensor sizes; reed_tpu's step
    on the same weights and draws on both paths; train-protein --tp 2
    through the CLI; this rank's place on the mesh."""
    results = {}
    mesh = tp_mesh(tensor=2)
    for key, fields in PTP_VARIANTS.items():
        with settings(mesh, fields=fields):
            results[key] = run_case("protein", save_first=out / ptp_first(key))
    with settings(mesh):
        results["resume"] = resume_across(out, "protein", "ckpt_ptp", "ckpt_one_protein")
    inputs = torch.load(out / "jax_protein_inputs.pt", weights_only=False)
    for path, mode in (("fused", "on"), ("off", "off")):
        results["jax", path] = protein_jax_parity_step(inputs, mode)
    results["cli"] = protein_cli(out, ["--distributed", "--tp", "2"], "tp")
    with settings(mesh):
        trainer, _ = _protein()
    results["axes"] = (trainer.dp.process_rank, trainer.dp.rank, trainer.dp.world,
                       trainer.dp.tensor_index)
    torch.save(results, out / f"ptp_rank{dp.process_rank}.pt")


def _job_protein_tensor_parallel_mesh(out, dp):
    """On four ranks: the protein case at data=2 x tensor=2 and fsdp=2 x
    tensor=2."""
    results = {}
    for name, axes in PTP_MESHES_4.items():
        with settings(tp_mesh(**axes)):
            results[name] = run_case("protein", save_first=out / ptp_first(name))
    torch.save(results, out / f"ptp_mesh_rank{dp.process_rank}.pt")


JOBS = {"mesh": _job_mesh, "data_parallel": _job_data_parallel, "fsdp": _job_fsdp,
        "fsdp_mesh": _job_fsdp_mesh, "remat": _job_remat,
        "tensor_parallel": _job_tensor_parallel,
        "tensor_parallel_mesh": _job_tensor_parallel_mesh,
        "protein_tensor_parallel": _job_protein_tensor_parallel,
        "protein_tensor_parallel_mesh": _job_protein_tensor_parallel_mesh}


if __name__ == "__main__":
    torch.set_num_threads(1)
    from reed_tpu_torch.parallel.mesh import init_distributed

    job, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
    _, dp = init_distributed("cpu", init_method=f"file://{out_dir / 'store'}")
    JOBS[job](out_dir, dp)
    torch.distributed.destroy_process_group()
