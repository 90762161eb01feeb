"""Convergence acceptance run of the port: the RDM learns a
class-conditional representation distribution.

The port's mirror of tools/convergence_rdm.py, with the configuration of
the committed TPU record (CONVERGENCE_RDM.json `config`): SimpleMLP over
64-d reps, width 256 x 4 blocks, atom-count classes keyed by 10, 14, 18
and 22 atoms (data/synthetic.rdm_gaussian_batch: orthogonal means |mu| =
2, sigma 0.25), batch 256, Adam lr 3e-4 constant, clip 1.0, EMA 0.995,
3,000 steps, f32 with TF32 off. Batches come from the same numpy seeds as
the JAX tool's (default_rng(step)). Then 512 reps (128 a class) are
sampled by 100 DDIM steps (eta 0) and scored: nearest-mean class accuracy
(chance 0.25), the per-class sample-mean error against the true mean
(untrained 2.0) and the RMS spread (true sigma * sqrt(C) = 2.0), with the
parameters and with the EMA.

The rule: 3,000 steps at each of the seeds 0-4 (the weights and the
training draws); the median final EMA class accuracy must reach 0.95 and
the median final EMA class-mean error must stay at or below 0.5 (TPU
record, one seed: 1.0 and 0.206).

  python -m reed_tpu_torch.tools.convergence_rdm               # the card
  python -m reed_tpu_torch.tools.convergence_rdm --tiny --device cpu

Writes CONVERGENCE_RDM_TORCH.json (or --out).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
from reed_tpu_torch.data.synthetic import (RDM_CLASS_SIGMA, RDM_CLASS_SIZES, rdm_class_means,
                                           rdm_gaussian_batch)
from reed_tpu_torch.tools.convergence_protein import device_name
from reed_tpu_torch.train.rdm import RDMTrainConfig, RDMTrainer, batch_to_device

STEPS = 3000
SEEDS = (0, 1, 2, 3, 4)
ACC_BAR = 0.95
ERR_BAR = 0.5


def gate_config(seed: int = 0, channels: int = 64, model_channels: int = 256,
                blocks: int = 4, batch_size: int = 256, lr: float = 3e-4) -> RDMTrainConfig:
    """The convergence run's configuration, as tools/convergence_rdm.py
    builds it for the TPU record."""
    return RDMTrainConfig(
        channels=channels, model_channels=model_channels, bottleneck_channels=model_channels,
        num_res_blocks=blocks, time_embed_dim=model_channels,
        max_nodes=max(RDM_CLASS_SIZES) + 2, batch_size=batch_size,
        optim=OptimConfig(lr=lr, weight_decay=0.0, schedule="constant", warmup_steps=0,
                          grad_clip=1.0),
        curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0,
                                    ema_decay=0.995),
        seed=seed)


def score(trainer: RDMTrainer, model, channels: int, n_eval: int, ddim_steps: int,
          seed: int) -> dict:
    """Sample n_eval reps (an equal share a class) by DDIM and score them."""
    mus = rdm_class_means(channels)
    k_classes = len(RDM_CLASS_SIZES)
    k = np.repeat(np.arange(k_classes), n_eval // k_classes)
    n_nodes = torch.as_tensor(np.asarray(RDM_CLASS_SIZES)[k], device=trainer.device)
    rep = trainer.diffusion(model).ddim_sample(
        (len(k), channels), n_nodes, num_steps=ddim_steps, eta=0.0,
        generator=torch.Generator(device=trainer.device).manual_seed(seed)).cpu().numpy()
    d = np.linalg.norm(rep[:, None] - mus[None], axis=-1)
    mean_err = spread = 0.0
    for kk in range(k_classes):
        r = rep[k == kk]
        mean_err += float(np.linalg.norm(r.mean(0) - mus[kk]))
        spread += float(np.sqrt(((r - r.mean(0)) ** 2).sum(-1).mean()))
    return {"class_acc": float((d.argmin(1) == k).mean()),
            "class_mean_err": mean_err / k_classes, "rms_spread": spread / k_classes}


def run_seed(args, seed: int, device: torch.device) -> dict:
    """Train one seed and score it at step 0 and at the end."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = gate_config(seed, args.channels, args.model_channels, args.blocks, args.batch_size,
                      args.lr)
    trainer = RDMTrainer(cfg, device=device)
    state = trainer.init_state()
    step0 = score(trainer, state.model.eval(), args.channels, args.n_eval, args.ddim_steps, 0)
    print(f"[seed {seed}] step-0: {step0}", flush=True)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = batch_to_device(rdm_gaussian_batch(np.random.default_rng(step),
                                                   args.batch_size, args.channels), device)
        state, metrics = trainer.train_step(state, batch)
        if step % 200 == 0 or step == args.steps - 1:
            loss = float(metrics["denoising_loss"])
            losses.append({"step": step, "loss": round(loss, 5)})
            print(f"[seed {seed}] step {step}: loss={loss:.5f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0
    final_ema = score(trainer, trainer.ema_model(state), args.channels, args.n_eval,
                      args.ddim_steps, 1)
    final = score(trainer, state.model.eval(), args.channels, args.n_eval, args.ddim_steps, 1)
    print(f"[seed {seed}] final: params={final} ema={final_ema}", flush=True)
    return {"seed": seed, "step0": step0, "final": final, "final_ema": final_ema,
            "train_seconds": round(train_secs, 1),
            "ms_per_step": round(1e3 * train_secs / max(args.steps, 1), 3),
            "loss_curve": losses}


def verdict(runs) -> dict:
    """The medians over the seeds' runs and the rule's verdict."""
    acc = statistics.median(r["final_ema"]["class_acc"] for r in runs)
    err = statistics.median(r["final_ema"]["class_mean_err"] for r in runs)
    return {"domain": "rdm", "metric": "class_acc/class_mean_err/rms_spread",
            "rule": (f"median over seeds of the final EMA class_acc >= {ACC_BAR} and of the "
                     f"final EMA class_mean_err <= {ERR_BAR}"),
            "bars": {"class_acc": ACC_BAR, "class_mean_err": ERR_BAR},
            "median_final_ema": {"class_acc": acc, "class_mean_err": err,
                                 "rms_spread": statistics.median(
                                     r["final_ema"]["rms_spread"] for r in runs)},
            "passed": sum(r["final_ema"]["class_acc"] >= ACC_BAR
                          and r["final_ema"]["class_mean_err"] <= ERR_BAR for r in runs),
            "pass": acc >= ACC_BAR and err <= ERR_BAR and len(runs) == len(SEEDS),
            "seeds": [r["seed"] for r in runs]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--model-channels", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ddim-steps", type=int, default=100)
    ap.add_argument("--n-eval", type=int, default=512)
    ap.add_argument("--out", default="CONVERGENCE_RDM_TORCH.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tiny", action="store_true", help="smoke-test scale, first seed only")
    args = ap.parse_args(argv)
    if args.tiny:
        args.steps = min(args.steps, 400)
        args.batch_size, args.channels, args.model_channels, args.blocks = 64, 16, 64, 2
        args.ddim_steps, args.n_eval = 50, 128
        args.seeds = args.seeds[:1]
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    runs = [run_seed(args, seed, device) for seed in args.seeds]
    result = {
        **verdict(runs), "steps": args.steps,
        "untrained_mean_err": 2.0, "chance_acc": 1.0 / len(RDM_CLASS_SIZES),
        "true_sigma_spread": RDM_CLASS_SIGMA * float(np.sqrt(args.channels)),
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "platform": device.type, "device": device_name(device),
        "config": {"batch_size": args.batch_size, "channels": args.channels,
                   "model_channels": args.model_channels, "blocks": args.blocks,
                   "lr": args.lr, "schedule": "constant", "grad_clip": 1.0,
                   "ema_decay": 0.995, "ddim_steps": args.ddim_steps, "n_eval": args.n_eval,
                   "dtype": "float32", "tf32": False},
        "runs": runs,
        "command": " ".join(["python -m reed_tpu_torch.tools.convergence_rdm", *argv]),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


if __name__ == "__main__":
    main()
