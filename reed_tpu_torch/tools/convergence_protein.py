"""Convergence acceptance run of the port: protein inverse folding learns a
deterministic sequence <-> structure rule to high recovery.

The port's mirror of tools/convergence_protein.py, with its defaults: train
ProteinMPNN-FMIF (hidden 128, 3 + 3 layers, K 30, f32, no alignment loss,
denoising on from step 0) on `protein_rule_batch` (each residue's identity
is encoded in its O-atom offset), then generate sequences for held-out
backbones with the Euler unmasking sampler and score sequence recovery with
the parameters and with the EMA. An untrained model scores ~1/20; the JAX
run on a TPU reached 1.00 (CONVERGENCE_PROTEIN.json). Batches are drawn
from the same numpy seeds as the JAX tool's.

  python -m reed_tpu_torch.tools.convergence_protein            # the card
  python -m reed_tpu_torch.tools.convergence_protein --tiny --device cpu

Writes CONVERGENCE_PROTEIN_TORCH.json (or --out). `--seed` (weights and
training draws) and `--fused-messages off` (the unfused chain instead of
the CUDA kernels) repeat the run for the seed-to-seed and path-to-path
comparison in PERF.md; the defaults are the JAX tool's run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
from reed_tpu_torch.data.synthetic import protein_rule_batch
from reed_tpu_torch.diffusion.discrete import MaskingInterpolantConfig
from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

DIMS = dict(single_dim=8, pair_dim=4, structure_dim=8)


def gate_config(hidden: int = 128, length: int = 48, batch_size: int = 16,
                lr: float = 1e-3, dropout: float = 0.0, sampler_steps: int = 200,
                seed: int = 0, fused_messages: str = "auto") -> ProteinTrainConfig:
    """The convergence run's configuration, as tools/convergence_protein.py
    builds it."""
    return ProteinTrainConfig(
        seed=seed, fused_messages=fused_messages,
        hidden_dim=hidden, k_neighbors=min(30, length), dropout=dropout,
        load_repr=False, repr_weight=0.0, **DIMS, batch_size=batch_size,
        max_len=length,
        interpolant=MaskingInterpolantConfig(num_timesteps=sampler_steps),
        optim=OptimConfig(lr=lr, grad_clip=1.0),
        # the EMA horizon ~1 / (1 - decay) steps must fit the run
        curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0,
                                    ema_decay=0.995))


def rule_batch(seed: int, batch_size: int, length: int, device):
    """protein_rule_batch from np.random.default_rng(seed), on `device`."""
    arrays = protein_rule_batch(np.random.default_rng(seed), batch_size, length, **DIMS)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--length", type=int, default=48)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sampler-steps", type=int, default=200)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-messages", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--out", default="CONVERGENCE_PROTEIN_TORCH.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tiny", action="store_true", help="smoke-test scale")
    args = ap.parse_args(argv)
    if args.tiny:
        args.steps = min(args.steps, 400)
        args.batch_size, args.length, args.hidden = 8, 16, 64
        args.sampler_steps, args.eval_batches = 50, 2

    device = resolve_device(args.device)
    trainer = ProteinTrainer(gate_config(args.hidden, args.length, args.batch_size,
                                         args.lr, args.dropout, args.sampler_steps,
                                         args.seed, args.fused_messages),
                             device=device)
    state = trainer.init_state()

    def recovery(ema: bool, seed0: int) -> float:
        """Sample sequences for held-out backbones; the fraction recovered."""
        hits = total = 0
        for i in range(args.eval_batches):
            batch = rule_batch(10_000 + seed0 + i, args.batch_size, args.length, device)
            _, tokens = trainer.sample(
                state, batch, torch.Generator(device=device).manual_seed(seed0 + i), ema=ema)
            hits += int((tokens == batch["S"]).sum())
            total += batch["S"].numel()
        return hits / total

    t0 = time.perf_counter()
    rec0 = recovery(False, 0)
    print(f"step-0 recovery: {rec0:.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)

    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = rule_batch(step, args.batch_size, args.length, device)
        state, metrics = trainer.train_step(state, batch)
        if step % 100 == 0 or step == args.steps - 1:
            ce, acc = float(metrics["denoising_loss"]), float(metrics["accuracy"])
            losses.append({"step": step, "ce": ce, "train_acc": acc})
            print(f"step {step}: ce={ce:.4f} acc={acc:.4f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0

    rec_ema = recovery(True, 1)
    rec_final = recovery(False, 1)
    print(f"final recovery: params={rec_final:.4f} ema={rec_ema:.4f}", flush=True)
    result = {
        "domain": "protein_fmif",
        "metric": "sequence_recovery",
        "step0": rec0,
        "final": rec_final,
        "final_ema": rec_ema,
        "chance": 1.0 / 20.0,
        "steps": args.steps,
        "train_seconds": round(train_secs, 1),
        "ms_per_step": round(1e3 * train_secs / max(args.steps, 1), 3),
        "platform": device.type,
        "device": device_name(device),
        "config": {"batch_size": args.batch_size, "length": args.length,
                   "hidden": args.hidden, "lr": args.lr, "dtype": "float32",
                   "dropout": args.dropout, "sampler_steps": args.sampler_steps,
                   "seed": args.seed, "fused_messages": args.fused_messages},
        "loss_curve": losses,
        "command": "python -m reed_tpu_torch.tools.convergence_protein"
                   + (" --tiny" if args.tiny else "")
                   + (f" --device {args.device}" if args.device != "cuda" else "")
                   + (f" --dropout {args.dropout}" if args.dropout else "")
                   + (f" --lr {args.lr}" if args.lr != 1e-3 else "")
                   + (f" --seed {args.seed}" if args.seed else "")
                   + (f" --fused-messages {args.fused_messages}"
                      if args.fused_messages != "auto" else ""),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "loss_curve"}))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
