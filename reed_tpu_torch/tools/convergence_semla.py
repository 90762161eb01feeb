"""Convergence acceptance run of the port: SemlaFlow learns a molecule
family to high validity and uniqueness.

The port's mirror of tools/convergence_semla.py, with the configuration of
the committed TPU record (CONVERGENCE_SEMLA.json `config`): the decorated
chains family (1,089 rigid classes of 2-6 heavy atoms with hydrogens,
coordinates scaled by the family's rms 1.3487), SemlaGenerator d_model 128,
4 layers, 16 coordinate sets, d_edge 64, 8 heads, f32, self-conditioning,
rep conditioning (adaLN on a 64-d per-class embedding from seed 4242, the
exact rep distribution), no alignment loss, training coordinate noise 0.2,
uniform-sample categoricals; batch 128, Adam lr 3e-4 with a cosine decay
over the run and clip 1.0, EMA 0.995, 20,000 steps. Batches come from the
same numpy seeds as the JAX tool's (default_rng(step)). Then 256 molecules
are integrated from the prior in 100 steps (categorical noise level 1) and
their predicted graphs scored (GraphMoleculeMetrics: validity, stability,
uniqueness), with the parameters and with the EMA. Untrained: ~0. The TPU
record reads final EMA validity 0.984 on one seed.

The rule: 20,000 steps at each of the seeds 0-4 (weights and the
self-conditioning coins), and the median of the final EMA validity must
reach 0.95. One seed is no verdict.

  python -m reed_tpu_torch.tools.convergence_semla               # the card
  python -m reed_tpu_torch.tools.convergence_semla --tiny --device cpu

The seeds run as concurrent processes on the one card: the step is bound by the host's kernel launches (~2,850 a
step), so five processes share the card well. Each builds its host
batches in a DataLoader worker where the host has two cores a seed, else
inline.
Writes CONVERGENCE_SEMLA_TORCH.json (or --out): each seed's run, the
medians and the verdict.

`--templates` runs the configuration of the bf16 TPU record instead
(CONVERGENCE_SEMLA_BF16.json, written by the JAX tool of commit c76e714):
the 4 rigid QM9 templates in raw coordinates, no reps and no alignment,
the type loss at weight 1, no training coordinate noise, categorical
noise level 0, constant lr 3e-4 with clip 1.0, EMA 0.995, 3,000 steps;
256 molecules integrated in 100 steps and scored by MoleculeMetrics (bonds
from distances). With `--dtype bfloat16` that is the mixed-precision gate
(bf16 features and messages, f32 coordinates), under the same rule,
written to CONVERGENCE_SEMLA_BF16_TORCH.json:

  python -m reed_tpu_torch.tools.convergence_semla --templates --dtype bfloat16

`--dtype bfloat16` without `--templates` runs the chains / rep gate in
mixed precision (CONVERGENCE_SEMLA_CHAINS_BF16_TORCH.json), which the JAX
tool reports to plateau (tools/convergence_semla.py:128-136).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
from reed_tpu_torch.data.synthetic import (CHAIN_MAX_ATOMS, MOLECULE_TEMPLATES,
                                           TEMPLATE_MAX_ATOMS, TEMPLATE_NUM_TYPES,
                                           chain_templates, template_molecule_batch)
from reed_tpu_torch.diffusion.molecule_fm import (IntegratorConfig,
                                                  MoleculeInterpolantConfig,
                                                  MoleculePriorConfig, interpolate_batch)
from reed_tpu_torch.eval.molecule_metrics import (SEMLA_IDX_CHARGES, GraphMoleculeMetrics,
                                                  MoleculeMetrics)
from reed_tpu_torch.tools.convergence_protein import device_name
from reed_tpu_torch.train.molecule_semla import (SemlaTrainConfig, SemlaTrainer,
                                                 batch_to_device)

# the TPU record's run length; one seed is no verdict, so the bar is held by
# the median over five seeds
STEPS = 20_000
TEMPLATE_STEPS = 3000   # the bf16 TPU record's run length
SEEDS = (0, 1, 2, 3, 4)
BAR = 0.95
N_BOND_TYPES, N_CHARGE_TYPES = 5, 7
D_REP = 64


class GateData:
    """The chains family, its coordinate scale and the per-class reps (or,
    with `templates`, the 4 rigid templates in raw coordinates, no reps);
    `batch(step)` is the training batch of a step, host numpy from
    default_rng(step), as the JAX tool's host_batch builds it."""

    def __init__(self, batch_size: int = 128, templates: bool = False):
        self.templates = templates
        if templates:
            self.family, self.max_n = MOLECULE_TEMPLATES, TEMPLATE_MAX_ATOMS
            self.coord_std, self.class_embs = 1.0, None
        else:
            self.family, self.max_n = chain_templates(), CHAIN_MAX_ATOMS
            self.coord_std = float(np.sqrt(np.mean(np.concatenate(
                [t["coords"] for t in self.family], axis=0) ** 2)))
            # a fixed per-class embedding table: the exact rep distribution
            # (f32, as the JAX tool's reaches its device)
            self.class_embs = (np.random.default_rng(4242).standard_normal(
                (len(self.family), D_REP)).astype(np.float32)
                / np.sqrt(D_REP)).astype(np.float32)
        self.batch_size = batch_size
        self.interpolant = gate_config(templates=templates).interpolant

    def batch(self, step: int):
        r = np.random.default_rng(step)
        raw = template_molecule_batch(r, self.batch_size, self.max_n, templates=self.family)
        mask = raw["mask"]
        data = {"coords": raw["coords"] / self.coord_std,
                "atomics": np.eye(TEMPLATE_NUM_TYPES, dtype=np.float32)[raw["types"]]
                * mask[..., None],
                "bonds": np.eye(N_BOND_TYPES, dtype=np.float32)[
                    np.minimum(raw["bond_orders"], 4)],
                "charges": np.zeros((self.batch_size, self.max_n, N_CHARGE_TYPES),
                                    np.float32),
                "mask": mask}
        data["charges"][..., 0] = mask
        prior, interpolated, times = interpolate_batch(r, self.interpolant, data)
        batch = {"data": data, "prior": prior, "interpolated": interpolated, "times": times}
        if self.class_embs is not None:
            batch["rep"] = self.class_embs[raw["template_idx"]]
        return batch


class _Batches(torch.utils.data.IterableDataset):
    def __init__(self, data: GateData, steps: int):
        self.data, self.steps = data, steps

    def __iter__(self):
        return (self.data.batch(step) for step in range(self.steps))


def gate_batches(data: GateData, steps: int, device: torch.device, workers: int = 1):
    """The batches of steps 0..steps-1 on `device`, built by `workers`
    DataLoader worker processes (0: inline) and uploaded from pinned memory
    on the card; the prior stays on the host (the step does not read it)."""
    loader = torch.utils.data.DataLoader(_Batches(data, steps), batch_size=None,
                                         num_workers=workers,
                                         pin_memory=device.type == "cuda",
                                         prefetch_factor=4 if workers else None)
    for batch in loader:
        yield batch_to_device(batch, device)


def gate_config(seed: int = 0, batch_size: int = 128, d_model: int = 128, layers: int = 4,
                coord_sets: int = 16, steps: int = STEPS, integrator_steps: int = 100,
                templates: bool = False, dtype: str = "float32") -> SemlaTrainConfig:
    """The convergence run's configuration, as tools/convergence_semla.py
    builds it for the TPU record (with `templates`, as the tool of commit
    c76e714 built it for the bf16 record), in `dtype`."""
    prior = MoleculePriorConfig(vocab_size=TEMPLATE_NUM_TYPES, n_bond_types=N_BOND_TYPES)
    if templates:
        return SemlaTrainConfig(
            vocab_size=TEMPLATE_NUM_TYPES, n_bond_types=N_BOND_TYPES,
            n_charge_types=N_CHARGE_TYPES, max_atoms=TEMPLATE_MAX_ATOMS, d_model=d_model,
            d_message=d_model // 2, n_layers=layers, n_coord_sets=coord_sets,
            d_message_hidden=d_model // 2, d_edge=64, n_attn_heads=8, size_emb=16,
            d_rep=None, rep_alignment=False, type_loss_weight=1.0,
            interpolant=MoleculeInterpolantConfig(prior=prior),
            integrator=IntegratorConfig(steps=integrator_steps), batch_size=batch_size,
            compute_dtype=dtype, optim=OptimConfig(lr=3e-4, grad_clip=1.0),
            curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0,
                                        ema_decay=0.995),
            seed=seed)
    return SemlaTrainConfig(
        vocab_size=TEMPLATE_NUM_TYPES, n_bond_types=N_BOND_TYPES,
        n_charge_types=N_CHARGE_TYPES, max_atoms=CHAIN_MAX_ATOMS, d_model=d_model,
        d_message=d_model // 2, n_layers=layers, n_coord_sets=coord_sets,
        d_message_hidden=d_model // 2, d_edge=64, n_attn_heads=8, size_emb=16,
        d_rep=D_REP, cond_type="adaLN", rep_alignment=False,
        interpolant=MoleculeInterpolantConfig(prior=prior, coord_noise_std=0.2),
        integrator=IntegratorConfig(steps=integrator_steps, cat_noise_level=1.0),
        batch_size=batch_size, compute_dtype=dtype,
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, schedule="cosine", total_steps=steps),
        curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0,
                                    ema_decay=0.995),
        seed=seed)


def score(trainer: SemlaTrainer, model, data: GateData, seed: int, n_eval: int) -> dict:
    """Integrate n_eval molecules of random classes (sizes and reps of their
    class) from the prior and score their predicted graphs (the templates:
    bonds from distances, as the bf16 record scored them)."""
    r = np.random.default_rng(30_000 + seed)
    cls = r.integers(0, len(data.family), size=n_eval)
    sizes = np.array([len(data.family[i]["types"]) for i in cls])
    mask = (np.arange(data.max_n)[None, :] < sizes[:, None]).astype(np.float32)
    prior = trainer.sample_prior(r, mask)
    rep = (None if data.class_embs is None
           else torch.from_numpy(data.class_embs[cls]).to(trainer.device))
    final = trainer.generate(model, prior, rep=rep, generator=torch.Generator(
        device=trainer.device).manual_seed(seed))
    out = {k: v.cpu().numpy() for k, v in final.items()}
    coords = out["coords"] * data.coord_std
    types = np.argmax(out["atomics"], axis=-1)
    if data.templates:
        return MoleculeMetrics().evaluate([(coords[b, :n], types[b, :n])
                                           for b, n in enumerate(sizes)])
    orders = np.argmax(out["bonds"], axis=-1)
    charges = np.asarray(SEMLA_IDX_CHARGES, np.int64)[np.argmax(out["charges"], axis=-1)]
    mols = [(coords[b, :n], types[b, :n], orders[b, :n, :n], charges[b, :n])
            for b, n in enumerate(sizes)]
    return GraphMoleculeMetrics().evaluate(mols)


def run_seed(args, seed: int, device: torch.device) -> dict:
    """Train one seed and score it at step 0 and at the end."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = gate_config(seed, args.batch_size, args.d_model, args.layers, args.coord_sets,
                      args.steps, args.integrator_steps, args.templates, args.dtype)
    data = GateData(args.batch_size, args.templates)
    trainer = SemlaTrainer(cfg, device=device)
    state = trainer.init_state()
    step0 = score(trainer, state.model, data, 0, args.n_eval)
    print(f"[seed {seed}] step-0: {step0}", flush=True)

    losses = []
    t0 = time.perf_counter()
    for step, batch in enumerate(gate_batches(data, args.steps, device, args.workers)):
        state, metrics = trainer.train_step(state, batch)
        if step % 200 == 0 or step == args.steps - 1:
            loss, coord = float(metrics["denoising_loss"]), float(metrics["coord_loss"])
            losses.append({"step": step, "loss": loss, "coord": coord})
            print(f"[seed {seed}] step {step}: loss={loss:.4f} coord={coord:.4f}",
                  flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0

    final_ema = score(trainer, trainer.ema_model(state), data, 1, args.n_eval)
    final = score(trainer, state.model, data, 1, args.n_eval)
    print(f"[seed {seed}] final: params={final} ema={final_ema}", flush=True)
    return {"seed": seed, "step0": step0, "final": final, "final_ema": final_ema,
            "train_seconds": round(train_secs, 1),
            "ms_per_step": round(1e3 * train_secs / max(args.steps, 1), 3),
            "loss_curve": losses}


def _run_concurrently(args, argv):
    """Each seed in a process of its own (all on the one card); returns the
    runs in seed order."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for seed in args.seeds:
            cmd = [sys.executable, "-m", "reed_tpu_torch.tools.convergence_semla", *argv,
                   "--seeds", str(seed), "--out",
                   os.path.join(tmp, f"seed{seed}.json")]
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(cmd, env=env))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"seed processes exited {codes}")
        runs = []
        for seed in args.seeds:
            with open(os.path.join(tmp, f"seed{seed}.json")) as f:
                runs.extend(json.load(f)["runs"])
    return runs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help=f"default {STEPS}, or {TEMPLATE_STEPS} with --templates")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--coord-sets", type=int, default=16)
    ap.add_argument("--integrator-steps", type=int, default=100)
    ap.add_argument("--n-eval", type=int, default=256)
    ap.add_argument("--workers", type=int, default=None,
                    help="DataLoader worker processes building host batches (0: inline; "
                         "default 1 where the host has two cores for each concurrent "
                         "seed, else 0)")
    ap.add_argument("--templates", action="store_true",
                    help="the bf16 TPU record's configuration (the 4 templates, no reps)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="compute dtype (bfloat16: reed_tpu's mixed precision)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tiny", action="store_true", help="smoke-test scale, first seed only")
    args = ap.parse_args(argv)
    if args.steps is None:
        args.steps = TEMPLATE_STEPS if args.templates else STEPS
    if args.out is None:
        args.out = {(False, "float32"): "CONVERGENCE_SEMLA_TORCH.json",
                    (True, "bfloat16"): "CONVERGENCE_SEMLA_BF16_TORCH.json",
                    (True, "float32"): "CONVERGENCE_SEMLA_TEMPLATES_TORCH.json",
                    (False, "bfloat16"): "CONVERGENCE_SEMLA_CHAINS_BF16_TORCH.json"}[
            (args.templates, args.dtype)]
    if args.tiny:
        args.steps = min(args.steps, 300)
        args.batch_size, args.d_model, args.layers, args.coord_sets = 32, 64, 2, 8
        args.integrator_steps, args.n_eval = 50, 64
        args.seeds = args.seeds[:1]

    device = resolve_device(args.device)
    concurrent = len(args.seeds) > 1
    if args.workers is None:
        # a worker only helps where it gets a core of its own
        args.workers = int((os.cpu_count() or 1) >= 2 * (len(args.seeds) if concurrent else 1))
    t0 = time.perf_counter()
    if concurrent:
        runs = _run_concurrently(args, argv + ["--workers", str(args.workers)])
    else:
        runs = [run_seed(args, seed, device) for seed in args.seeds]
    med = {k: statistics.median(r["final_ema"][k] for r in runs)
           for k in ("validity", "mol_stable", "atom_stable", "uniqueness", "fc_validity")
           if k in runs[0]["final_ema"]}
    result = {
        "domain": "molecule_semla",
        "metric": ("validity/mol_stable/atom_stable/uniqueness (bonds from distances)"
                   if args.templates else
                   "validity/mol_stable/atom_stable/uniqueness (predicted graphs)"),
        "rule": f"median over seeds of the final EMA validity >= {BAR}",
        "bar": BAR,
        "median_final_ema": med,
        "median_final_validity": statistics.median(r["final"]["validity"] for r in runs),
        "passed": sum(r["final_ema"]["validity"] >= BAR for r in runs),
        "pass": med["validity"] >= BAR,
        "steps": args.steps,
        "seeds": args.seeds,
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "platform": device.type,
        "device": device_name(device),
        "config": ({"batch_size": args.batch_size, "d_model": args.d_model,
                    "layers": args.layers, "coord_sets": args.coord_sets,
                    "lr": 3e-4, "schedule": "constant", "grad_clip": 1.0,
                    "integrator_steps": args.integrator_steps, "dtype": args.dtype,
                    "train_coord_noise": 0.0, "cat_noise_level": 0.0,
                    "type_loss_weight": 1.0, "self_cond": True, "rep_condition": False,
                    "family": "templates", "n_classes": len(MOLECULE_TEMPLATES),
                    "ema_decay": 0.995, "n_eval": args.n_eval} if args.templates else
                   {"batch_size": args.batch_size, "d_model": args.d_model,
                    "layers": args.layers, "coord_sets": args.coord_sets,
                    "lr": 3e-4, "schedule": "cosine", "warmup": 0,
                    "integrator_steps": args.integrator_steps, "dtype": args.dtype,
                    "coord_skip": False, "train_coord_noise": 0.2, "cat_noise_level": 1.0,
                    "self_cond": True, "categorical_strategy": "uniform-sample",
                    "rep_condition": True, "cond_type": "adaLN", "d_rep": D_REP,
                    "family": "chains", "n_classes": len(chain_templates()),
                    "n_eval": args.n_eval}),
        "runs": runs,
        "command": " ".join(["python -m reed_tpu_torch.tools.convergence_semla", *argv]),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


if __name__ == "__main__":
    main()
