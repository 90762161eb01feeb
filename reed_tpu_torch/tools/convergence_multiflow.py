"""Convergence acceptance run of the port: MultiFlow SE(3) codesign learns
an ideal helix fold and a deterministic sequence rule.

The port's mirror of tools/convergence_multiflow.py, with the
configuration of the committed TPU records (CONVERGENCE_MULTIFLOW.json and
CONVERGENCE_MULTIFLOW_BF16.json `config`): randomly rotated ideal
alpha-helices of 32 residues whose tokens follow aatype[i] = i mod 20
(data/synthetic.helix_codesign_batch, numpy seed `step` for step's batch,
as the JAX tool's), FlowModel c_s 128, c_z 64, 3 blocks, batch 32, Adam
lr 3e-4 with clip 1.0, EMA 0.995, the plain centred Gaussian prior (no
batch OT), 3,000 steps, f32 with TF32 off or --dtype bfloat16. Then 64
samples (two batches of 32) are drawn from the prior by the 100-step Euler
sampler and scored: the sequence recovery against the i mod 20 rule
(chance 0.05), the Kabsch RMSD of the sampled CA trace to the ideal helix,
and the mean error of consecutive CA-CA distances against the helix's
3.83 A, with the parameters and with the EMA.

The rule, fixed before any run: 3,000 steps at each of the seeds 0-4 (the
weights and the training draws); the medians over the seeds of the final
EMA scores must reach recovery >= 0.95, CA RMSD <= 1.0 A and CA-CA bond
error <= 0.2 A. (The TPU's one seed read 1.0, 0.313 and 0.057 in f32 and
1.0, 0.349 and 0.056 in bf16.)

  python -m reed_tpu_torch.tools.convergence_multiflow                  # the card, f32
  python -m reed_tpu_torch.tools.convergence_multiflow --dtype bfloat16
  python -m reed_tpu_torch.tools.convergence_multiflow --tiny --device cpu

The seeds run as concurrent processes on the one card. Writes
CONVERGENCE_MULTIFLOW_TORCH.json (CONVERGENCE_MULTIFLOW_BF16_TORCH.json
with --dtype bfloat16; or --out): each seed's run, the medians and the
verdict; `--merge a.json b.json` combines the runs of separate
invocations into one verdict.
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
from reed_tpu_torch.data.synthetic import HELIX_CA_CA, helix_ca_trace, helix_codesign_batch
from reed_tpu_torch.diffusion.se3 import SE3InterpolantConfig
from reed_tpu_torch.eval.protein_metrics import kabsch_rmsd
from reed_tpu_torch.tools.convergence_protein import device_name
from reed_tpu_torch.train.multiflow import (MultiflowTrainConfig, MultiflowTrainer,
                                            batch_to_device)

STEPS = 3000
SEEDS = (0, 1, 2, 3, 4)
BARS = {"recovery": 0.95, "ca_rmsd": 1.0, "ca_bond_err": 0.2}  # >=, <=, <=
OUT = {"float32": "CONVERGENCE_MULTIFLOW_TORCH.json",
       "bfloat16": "CONVERGENCE_MULTIFLOW_BF16_TORCH.json"}


def gate_config(seed: int = 0, dtype: str = "float32", batch_size: int = 32, length: int = 32,
                c_s: int = 128, c_z: int = 64, blocks: int = 3, lr: float = 3e-4,
                sampler_steps: int = 100) -> MultiflowTrainConfig:
    """The convergence run's configuration, as tools/convergence_multiflow.py
    builds it for the TPU records."""
    return MultiflowTrainConfig(
        c_s=c_s, c_z=c_z, num_blocks=blocks, batch_size=batch_size, max_len=length,
        compute_dtype=dtype,
        interpolant=SE3InterpolantConfig(trans_batch_ot=False, num_timesteps=sampler_steps),
        optim=OptimConfig(lr=lr, grad_clip=1.0),
        curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0, ema_decay=0.995),
        seed=seed)


def gate_batch(step: int, batch_size: int = 32, length: int = 32, device=None):
    """Step's batch of the gate: helices from numpy seed `step`."""
    return batch_to_device(helix_codesign_batch(np.random.default_rng(step), batch_size,
                                                length), device)


def score(trainer: MultiflowTrainer, model, length: int, n_eval: int, seed0: int) -> dict:
    """Sample n_eval structures and sequences from the prior (batches of up
    to 32, generator seeds seed0, seed0 + 1, ...) and score them."""
    ideal = helix_ca_trace(length)
    target = np.arange(length) % 20
    bs = min(n_eval, 32)
    recov, rmsds, bond_errs = [], [], []
    for i in range(max(1, n_eval // bs)):
        out = trainer.sample(model, bs, length,
                             generator=torch.Generator(device=trainer.device).manual_seed(
                                 seed0 + i))
        trans = out["trans"].cpu().numpy()
        aat = out["aatypes"].cpu().numpy()
        recov.append(float((aat == target[None]).mean()))
        for b in range(bs):
            rmsds.append(kabsch_rmsd(trans[b], ideal))
            d = np.linalg.norm(np.diff(trans[b], axis=0), axis=-1)
            bond_errs.append(float(np.abs(d - HELIX_CA_CA).mean()))
    return {"recovery": float(np.mean(recov)), "ca_rmsd": float(np.mean(rmsds)),
            "ca_bond_err": float(np.mean(bond_errs))}


def run_seed(args, seed: int, device: torch.device) -> dict:
    """Train one seed and score it at step 0 and at the end."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = gate_config(seed, args.dtype, args.batch_size, args.length, args.c_s, args.c_z,
                      args.blocks, args.lr, args.sampler_steps)
    trainer = MultiflowTrainer(cfg, device=device)
    state = trainer.init_state()
    t0 = time.perf_counter()
    step0 = score(trainer, state.model.eval(), args.length, args.n_eval, 0)
    sample_secs = time.perf_counter() - t0
    print(f"[seed {seed}] step-0: {step0} ({sample_secs:.1f} s)", flush=True)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, metrics = trainer.train_step(
            state, gate_batch(step, args.batch_size, args.length, device))
        if step % 200 == 0 or step == args.steps - 1:
            m = {k: round(float(metrics[k]), 4) for k in
                 ("denoising_loss", "trans_loss", "rots_vf_loss", "aatypes_loss", "loss")}
            losses.append({"step": step, **m})
            print(f"[seed {seed}] step {step}: {m}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0
    final_ema = score(trainer, trainer.ema_model(state).eval(), args.length, args.n_eval, 1)
    final = score(trainer, state.model.eval(), args.length, args.n_eval, 1)
    print(f"[seed {seed}] final: params={final} ema={final_ema}", flush=True)
    return {"seed": seed, "step0": step0, "final": final, "final_ema": final_ema,
            "train_seconds": round(train_secs, 1),
            "ms_per_step": round(1e3 * train_secs / max(args.steps, 1), 3),
            "sample_seconds_step0": round(sample_secs, 1), "loss_curve": losses}


def _run_concurrently(args, argv):
    """Each seed in a process of its own (all on the one card); returns the
    runs in seed order."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for seed in args.seeds:
            cmd = [sys.executable, "-m", "reed_tpu_torch.tools.convergence_multiflow", *argv,
                   "--seeds", str(seed), "--out", os.path.join(tmp, f"seed{seed}.json")]
            procs.append(subprocess.Popen(cmd, env=dict(os.environ, OMP_NUM_THREADS="1")))
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"seed processes exited {codes}")
        runs = []
        for seed in args.seeds:
            with open(os.path.join(tmp, f"seed{seed}.json")) as f:
                runs.extend(json.load(f)["runs"])
    return runs


def verdict(runs, steps: int) -> dict:
    """The medians over the seeds' runs and the rule's verdict."""
    med = {k: statistics.median(r["final_ema"][k] for r in runs) for k in BARS}

    def ok(s):
        return (s["recovery"] >= BARS["recovery"] and s["ca_rmsd"] <= BARS["ca_rmsd"]
                and s["ca_bond_err"] <= BARS["ca_bond_err"])

    return {"domain": "multiflow_se3", "metric": "recovery/ca_rmsd/ca_bond_err",
            "rule": (f"medians over seeds 0-4 of the final EMA recovery >= "
                     f"{BARS['recovery']}, ca_rmsd <= {BARS['ca_rmsd']} A and ca_bond_err <= "
                     f"{BARS['ca_bond_err']} A"),
            "bars": BARS, "median_final_ema": med,
            "median_final": {k: statistics.median(r["final"][k] for r in runs) for k in BARS},
            "passed": sum(ok(r["final_ema"]) for r in runs),
            "pass": ok(med) and sorted(r["seed"] for r in runs) == list(SEEDS),
            "steps": steps, "seeds": [r["seed"] for r in runs]}


def merge(paths, out: str) -> dict:
    """One result from the runs of several invocations (seeds split over
    calls), each a file this tool wrote."""
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    runs = sorted((r for p in parts for r in p["runs"]), key=lambda r: r["seed"])
    if (len({r["seed"] for r in runs}) != len(runs) or len({p["steps"] for p in parts}) != 1
            or len({p["config"]["dtype"] for p in parts}) != 1):
        raise ValueError("the files repeat a seed or differ in steps or dtype")
    def each(key):   # a file that is itself a merge holds lists
        return [v for p in parts for v in (p[key] if isinstance(p[key], list) else [p[key]])]

    result = dict(parts[0], **verdict(runs, parts[0]["steps"]), runs=runs,
                  wall_seconds=each("wall_seconds"), command=each("command"))
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--dtype", default="float32", choices=sorted(OUT))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--length", type=int, default=32)
    ap.add_argument("--c-s", type=int, default=128)
    ap.add_argument("--c-z", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--sampler-steps", type=int, default=100)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--out", default=None, help="default: by --dtype, "
                    + ", ".join(f"{k}: {v}" for k, v in OUT.items()))
    ap.add_argument("--merge", nargs="+", default=None,
                    help="combine these result files into --out and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tiny", action="store_true", help="smoke-test scale, first seed only")
    args = ap.parse_args(argv)
    out = args.out or OUT[args.dtype]
    if args.merge:
        return merge(args.merge, out)
    if args.tiny:
        args.steps = min(args.steps, 300)
        args.batch_size, args.length = 8, 12
        args.c_s, args.c_z, args.blocks = 48, 24, 2
        args.sampler_steps, args.n_eval = 50, 16
        args.seeds = args.seeds[:1]
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if len(args.seeds) > 1:
        runs = _run_concurrently(args, argv)
    else:
        runs = [run_seed(args, seed, device) for seed in args.seeds]
    result = {
        **verdict(runs, args.steps),
        "chance_recovery": 1.0 / 20.0, "ideal_ca_ca": HELIX_CA_CA,
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "platform": device.type, "device": device_name(device),
        "config": {"batch_size": args.batch_size, "length": args.length, "c_s": args.c_s,
                   "c_z": args.c_z, "blocks": args.blocks, "lr": args.lr, "grad_clip": 1.0,
                   "ema_decay": 0.995, "trans_batch_ot": False, "dtype": args.dtype,
                   "tf32": False, "sampler_steps": args.sampler_steps, "n_eval": args.n_eval},
        "runs": runs,
        "command": " ".join(["python -m reed_tpu_torch.tools.convergence_multiflow", *argv]),
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


if __name__ == "__main__":
    main()
