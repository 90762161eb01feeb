"""Convergence acceptance run of the port: EDM learns a molecule family to
high validity and stability.

The port's mirror of tools/convergence_edm.py, with the configuration of
the committed TPU record (CONVERGENCE_EDM.json `config`): the decorated
chains family (1,089 rigid classes of 2-6 heavy atoms with hydrogens, at
most 20 atoms, randomly rotated), EGNNDynamics hidden 256, 6 blocks of one
GCL, rep-conditioned on a 64-d per-class embedding from seed 7 (the exact
rep distribution, no rep dropout), EDM with T = 1000 and the polynomial
schedule, f32 with TF32 off; batch 128, Adam lr 3e-4 with a cosine decay
over the run and clip 1.0, EMA 0.995, 40,000 steps. Batches come from the
same numpy seeds as the JAX tool's (default_rng(step)). Then 256 molecules
of random classes are sampled by the ancestral loop (1,000 steps, their
classes' sizes and reps) and scored by MoleculeMetrics (bonds from
distances: stability, validity, uniqueness), with the parameters and with
the EMA. Untrained: 0. The TPU record reads final EMA validity 0.973 on one
seed.

The rule: 40,000 steps at each of the seeds 0-4 (the weights and the
training draws), and the median of the final EMA validity must reach 0.95.
One seed is no verdict.

  python -m reed_tpu_torch.tools.convergence_edm               # the card
  python -m reed_tpu_torch.tools.convergence_edm --tiny --device cpu

The seeds run as concurrent processes on the one card, as the Semla gate's
do. `--score-every N` scores the EMA every N steps, as the JAX tool's
does, and keeps the curve; `--save-params p.pt` saves each seed's final
parameters and EMA (p_seed{k}.pt). Writes CONVERGENCE_EDM_TORCH.json (or
--out): each seed's run, the medians and the verdict; `--merge a.json
b.json` combines the runs of separate invocations (seeds split over
calls) into one verdict.

`--bf16-matmul-inputs` is a probe, not the gate: every f32 product
(F.linear, forward and both backward products) takes its operands rounded
to bf16 and accumulates in f32, as XLA's default precision computes an f32
dot on a TPU. It first holds a product on the device against an explicitly
rounded one (`check_bf16_matmul`) and writes
CONVERGENCE_EDM_TORCH_BF16MM_PROBE.json, never the gate's record.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import CurriculumConfig, OptimConfig
from reed_tpu_torch.data.synthetic import (CHAIN_MAX_ATOMS, TEMPLATE_NUM_TYPES,
                                           chain_templates, template_molecule_batch)
from reed_tpu_torch.diffusion.edm import EDMConfig
from reed_tpu_torch.eval.molecule_metrics import MoleculeMetrics
from reed_tpu_torch.eval.two_stage import molecule_masks
from reed_tpu_torch.tools.convergence_protein import device_name
from reed_tpu_torch.train.molecule_edm import (MoleculeEDMConfig, MoleculeEDMTrainer,
                                               batch_to_device)

# the TPU record's run length; one seed is no verdict, so the bar is held by
# the median over five seeds
STEPS = 40_000
SEEDS = (0, 1, 2, 3, 4)
BAR = 0.95
D_REP = 64
MEDIAN_KEYS = ("validity", "mol_stable", "atom_stable", "uniqueness")
GATE_RECORD = "CONVERGENCE_EDM_TORCH.json"
PROBE_RECORD = "CONVERGENCE_EDM_TORCH_BF16MM_PROBE.json"


def _mm_f32(a, b):
    """a @ b of bf16 operands, accumulated and returned in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _Bf16OperandLinear(torch.autograd.Function):
    """x @ w.T with x and w rounded to bf16, f32 accumulation; the backward
    rounds the incoming gradient too, so both of its products take bf16
    operands, as a TPU computes the transposed dots of a dot's gradient."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        return _mm_f32(xb.reshape(-1, xb.shape[-1]), wb.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
        gx = _mm_f32(gb, wb).reshape(xb.shape) if ctx.needs_input_grad[0] else None
        gw = (_mm_f32(gb.t(), xb.reshape(-1, xb.shape[-1]))
              if ctx.needs_input_grad[1] else None)
        return gx, gw


@contextlib.contextmanager
def bf16_matmul_inputs():
    """Inside: every F.linear of f32 tensors (nn.Linear's and the models'
    factored products alike) rounds its operands to bf16 and accumulates in
    f32; the bias is added in f32. The one GEMM of the EDM path is F.linear."""
    plain = F.linear

    def linear(x, w, b=None):
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            return plain(x, w, b)
        y = _Bf16OperandLinear.apply(x, w)
        return y if b is None else y + b

    F.linear = linear
    try:
        yield
    finally:
        F.linear = plain


def check_bf16_matmul(device: torch.device) -> dict:
    """Under bf16_matmul_inputs, one product [4096, 256] x [256, 256] and its
    input gradient on `device` against F.linear of explicitly bf16-rounded
    operands (f32, TF32 off): the rounded product must agree to 1e-5 of its
    max and differ from the unrounded one by more than 1e-4; raises
    otherwise."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((4096, 256), generator=g, device=device, requires_grad=True)
    w = torch.randn((256, 256), generator=g, device=device) / 16
    dy = torch.randn((4096, 256), generator=g, device=device)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    with bf16_matmul_inputs():
        y = F.linear(x, w)
    (gx,) = torch.autograd.grad(y, x, dy)
    ref = F.linear(r(x.detach()), r(w))
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    out = {"rounded": rel(y.detach(), ref), "unrounded": rel(F.linear(x.detach(), w), ref),
           "grad_rounded": rel(gx, r(dy) @ r(w)), "grad_unrounded": rel(gx, dy @ w)}
    if not (out["rounded"] < 1e-5 and out["grad_rounded"] < 1e-5
            and out["unrounded"] > 1e-4 and out["grad_unrounded"] > 1e-4):
        raise AssertionError(f"bf16 operand rounding not in effect on {device}: {out}")
    return out


class GateData:
    """The chains family and its per-class reps; `batch(step)` is the
    training batch of a step, host numpy from default_rng(step), as the JAX
    tool's host_batch builds it."""

    def __init__(self, batch_size: int = 128):
        self.family, self.max_n = chain_templates(), CHAIN_MAX_ATOMS
        self.class_embs = (np.random.default_rng(7).standard_normal(
            (len(self.family), D_REP)).astype(np.float32) / np.sqrt(D_REP)).astype(np.float32)
        self.batch_size = batch_size

    def batch(self, step: int):
        raw = template_molecule_batch(np.random.default_rng(step), self.batch_size,
                                      self.max_n, templates=self.family)
        mask = raw["mask"][..., None]
        diag = np.eye(self.max_n, dtype=np.float32)[None, :, :, None]
        return {"positions": raw["coords"],
                "one_hot": np.eye(TEMPLATE_NUM_TYPES, dtype=np.float32)[raw["types"]] * mask,
                "charges": raw["charges"][..., None] * mask, "node_mask": mask,
                "edge_mask": mask[:, :, None, :] * mask[:, None, :, :] * (1.0 - diag),
                "rep": self.class_embs[raw["template_idx"]]}


class _Batches(torch.utils.data.IterableDataset):
    def __init__(self, data: GateData, steps: int):
        self.data, self.steps = data, steps

    def __iter__(self):
        return (self.data.batch(step) for step in range(self.steps))


def gate_batches(data: GateData, steps: int, device: torch.device, workers: int = 0):
    """The batches of steps 0..steps-1 on `device`, built by `workers`
    DataLoader worker processes (0: inline) and uploaded from pinned memory
    on the card."""
    loader = torch.utils.data.DataLoader(_Batches(data, steps), batch_size=None,
                                         num_workers=workers,
                                         pin_memory=device.type == "cuda",
                                         prefetch_factor=4 if workers else None)
    for batch in loader:
        yield batch_to_device(batch, device)


def gate_config(seed: int = 0, batch_size: int = 128, hidden: int = 256, layers: int = 6,
                steps: int = STEPS, timesteps: int = 1000) -> MoleculeEDMConfig:
    """The convergence run's configuration, as tools/convergence_edm.py
    builds it for the TPU record."""
    return MoleculeEDMConfig(
        num_atom_types=TEMPLATE_NUM_TYPES, include_charges=True, max_nodes=CHAIN_MAX_ATOMS,
        hidden_nf=hidden, n_layers=layers, rep_nf=D_REP, rep_dropout_prob=0.0,
        edm=EDMConfig(timesteps=timesteps), batch_size=batch_size,
        optim=OptimConfig(lr=3e-4, grad_clip=1.0, schedule="cosine", total_steps=steps),
        curriculum=CurriculumConfig(proj_coeff=0.0, diffusion_warmup_steps=0,
                                    ema_decay=0.995),
        seed=seed)


def score(trainer: MoleculeEDMTrainer, model, data: GateData, seed: int,
          n_eval: int) -> dict:
    """Sample n_eval molecules of random classes (their sizes and reps) and
    score them."""
    r = np.random.default_rng(20_000 + seed)
    cls = r.integers(0, len(data.family), size=n_eval)
    sizes = np.array([len(data.family[i]["types"]) for i in cls])
    node_mask, edge_mask = molecule_masks(sizes, data.max_n, trainer.device)
    rep = torch.from_numpy(data.class_embs[cls]).to(trainer.device)
    x, h_cat, _ = trainer.sample(model, node_mask, edge_mask, rep=rep,
                                 generator=torch.Generator(device=trainer.device)
                                 .manual_seed(seed))
    x, types = x.cpu().numpy(), torch.argmax(h_cat, dim=-1).cpu().numpy()
    return MoleculeMetrics().evaluate([(x[b, :n], types[b, :n]) for b, n in enumerate(sizes)])


def params_path(path: str, seed: int) -> str:
    """--save-params' file for `seed`: the seed before the extension."""
    root, ext = os.path.splitext(path)
    return f"{root}_seed{seed}{ext or '.pt'}"


def run_seed(args, seed: int, device: torch.device) -> dict:
    """Train one seed and score it at step 0, every --score-every steps (the
    EMA) and at the end."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if args.bf16_matmul_inputs:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    precision = bf16_matmul_inputs() if args.bf16_matmul_inputs else contextlib.nullcontext()
    with precision:
        return _train_and_score(args, seed, device)


def _train_and_score(args, seed: int, device: torch.device) -> dict:
    cfg = gate_config(seed, args.batch_size, args.hidden, args.layers, args.steps,
                      args.timesteps)
    data = GateData(args.batch_size)
    trainer = MoleculeEDMTrainer(cfg, device=device)
    state = trainer.init_state()
    t0 = time.perf_counter()
    step0 = score(trainer, state.model, data, 0, args.n_eval)
    sample_secs = time.perf_counter() - t0
    print(f"[seed {seed}] step-0: {step0} ({sample_secs:.1f} s)", flush=True)

    losses, curve = [], []
    t0 = time.perf_counter()
    for step, batch in enumerate(gate_batches(data, args.steps, device, args.workers)):
        state, metrics = trainer.train_step(state, batch)
        if step % 200 == 0 or step == args.steps - 1:
            loss = float(metrics["denoising_loss"])
            losses.append({"step": step, "nll": loss})
            print(f"[seed {seed}] step {step}: nll={loss:.4f}", flush=True)
        if args.score_every and step and step % args.score_every == 0:
            mid = score(trainer, trainer.ema_model(state), data, 1, args.n_eval)
            curve.append({"step": step, **mid})
            print(f"[seed {seed}] step {step} ema: {mid}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0

    final_ema = score(trainer, trainer.ema_model(state), data, 1, args.n_eval)
    final = score(trainer, state.model, data, 1, args.n_eval)
    print(f"[seed {seed}] final: params={final} ema={final_ema}", flush=True)
    if args.save_params:
        path = params_path(args.save_params, seed)
        torch.save({"params": {k: v.cpu() for k, v in state.model.state_dict().items()},
                    "ema": {k: v.cpu() for k, v in state.ema.items()},
                    "config": {"seed": seed, "steps": args.steps, "hidden": args.hidden,
                               "layers": args.layers, "timesteps": args.timesteps}}, path)
        print(f"[seed {seed}] params saved: {path}", flush=True)
    run = {"seed": seed, "step0": step0, "final": final, "final_ema": final_ema,
           "train_seconds": round(train_secs, 1),
           "ms_per_step": round(1e3 * train_secs / max(args.steps, 1), 3),
           "sample_seconds_step0": round(sample_secs, 1), "loss_curve": losses}
    if args.score_every:
        run["ema_curve"] = curve + [{"step": args.steps, **final_ema}]
    return run


def _run_concurrently(args, argv):
    """Each seed in a process of its own (all on the one card); returns the
    runs in seed order."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for seed in args.seeds:
            cmd = [sys.executable, "-m", "reed_tpu_torch.tools.convergence_edm", *argv,
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
    med = {k: statistics.median(r["final_ema"][k] for r in runs) for k in MEDIAN_KEYS}
    return {"domain": "molecule_edm",
            "metric": "validity/mol_stable/atom_stable/uniqueness (bonds from distances)",
            "rule": f"median over seeds of the final EMA validity >= {BAR}", "bar": BAR,
            "median_final_ema": med,
            "median_final_validity": statistics.median(r["final"]["validity"] for r in runs),
            "passed": sum(r["final_ema"]["validity"] >= BAR for r in runs),
            "pass": med["validity"] >= BAR and len(runs) == len(SEEDS),
            "steps": steps, "seeds": [r["seed"] for r in runs]}


def merge(paths, out: str) -> dict:
    """One result from the runs of several invocations (seeds split over
    calls), each a file this tool wrote."""
    parts = []
    for path in paths:
        with open(path) as f:
            parts.append(json.load(f))
    runs = sorted((r for p in parts for r in p["runs"]), key=lambda r: r["seed"])
    if len({r["seed"] for r in runs}) != len(runs) or len({p["steps"] for p in parts}) != 1:
        raise ValueError("the files repeat a seed or differ in steps")
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
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--n-eval", type=int, default=256)
    ap.add_argument("--score-every", type=int, default=0,
                    help="score the EMA on --n-eval samples every N steps and keep the "
                         "curve (0: off)")
    ap.add_argument("--save-params", default="",
                    help="torch.save each seed's final params and EMA here, the seed "
                         "before the extension")
    ap.add_argument("--workers", type=int, default=None,
                    help="DataLoader worker processes building host batches (0: inline; "
                         "default 1 where the host has two cores for each concurrent "
                         "seed, else 0)")
    ap.add_argument("--bf16-matmul-inputs", action="store_true",
                    help="the probe: f32 products with bf16-rounded operands, as a TPU's "
                         f"default precision; writes {PROBE_RECORD}, never the gate's record")
    ap.add_argument("--out", default=None, help=f"default {GATE_RECORD} ({PROBE_RECORD} "
                                                "with --bf16-matmul-inputs)")
    ap.add_argument("--merge", nargs="+", default=None,
                    help="combine these result files into --out and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--tiny", action="store_true", help="smoke-test scale, first seed only")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = PROBE_RECORD if args.bf16_matmul_inputs else GATE_RECORD
    if args.bf16_matmul_inputs and os.path.basename(args.out) == GATE_RECORD:
        raise ValueError(f"the bf16-operand probe does not write the gate's record {GATE_RECORD}")
    if args.merge:
        return merge(args.merge, args.out)
    if args.tiny:
        args.steps = min(args.steps, 300)
        args.batch_size, args.hidden, args.layers = 32, 64, 2
        args.timesteps, args.n_eval = 100, 64
        args.seeds = args.seeds[:1]

    device = resolve_device(args.device)
    concurrent = len(args.seeds) > 1
    if args.workers is None:
        # a worker only helps where it gets a core of its own
        args.workers = int((os.cpu_count() or 1) >= 2 * (len(args.seeds) if concurrent else 1))
    check = check_bf16_matmul(device) if args.bf16_matmul_inputs else None
    if check:
        print(f"bf16 operand rounding on {device}: {check}", flush=True)
    t0 = time.perf_counter()
    if concurrent:
        runs = _run_concurrently(args, argv + ["--workers", str(args.workers)])
    else:
        runs = [run_seed(args, seed, device) for seed in args.seeds]
    result = {
        **verdict(runs, args.steps),
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "platform": device.type,
        "device": device_name(device),
        "config": {"batch_size": args.batch_size, "hidden": args.hidden,
                   "layers": args.layers, "lr": 3e-4, "schedule": "cosine", "warmup": 0,
                   "grad_clip": 1.0, "timesteps": args.timesteps, "dtype": "float32",
                   "tf32": False, "family": "chains", "rep_condition": True,
                   "d_rep": D_REP, "rep_dropout_prob": 0.0, "ema_decay": 0.995,
                   "n_classes": len(chain_templates()), "n_eval": args.n_eval,
                   "score_every": args.score_every,
                   "matmul_inputs": "bfloat16" if args.bf16_matmul_inputs else "float32"},
        "runs": runs,
        **({"bf16_matmul_check": check} if check else {}),
        "command": " ".join(["python -m reed_tpu_torch.tools.convergence_edm", *argv]),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "runs"}))
    return result


if __name__ == "__main__":
    main()
