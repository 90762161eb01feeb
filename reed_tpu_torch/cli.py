"""Command line of the PyTorch/CUDA port.

  python -m reed_tpu_torch.cli generate-image --model SiT-XL/2 \\
      --num-samples 64 --batch-size 32 --num-steps 250 --cfg-scale 1.8 \\
      --guidance-high 0.7 --ref-ckpt sit_xl.pt --vae vae_decoder.npz \\
      --out out/samples.npz
  python -m reed_tpu_torch.cli compute-fid ref.npz out/samples.npz \\
      --inception-npz inception.npz [--save-stats]
  python -m reed_tpu_torch.cli eval-protein --batch-size 8 --length 256 \\
      --num-steps 50 [--data-dir pdb_2021aug02] [--ref-ckpt epoch_last.pt]
  python -m reed_tpu_torch.cli train-protein --steps 100 --synthetic \\
      [--data-dir pdb_2021aug02 --token-budget 20000] [--set optim.lr=3e-4]
  python -m reed_tpu_torch.cli train-image --model SiT-XL/2 --batch-size 48 \\
      --steps 100 --synthetic [--data-dir latents/ --enc-type dinov2-vit-b \\
      --encoder-dir encoders/] [--ckpt-dir out/img --ckpt-every 1000]
  python -m reed_tpu_torch.cli train-molecule-semla \\
      --config recipes/molecule_semla_reed.json --steps 100 --synthetic \\
      [--data-dir qm9/ --batch-cost 4096] [--ckpt-dir out/semla --ckpt-every 1000]
  python -m reed_tpu_torch.cli eval-semla --n-samples 64 --n-replicates 3 \\
      --num-steps 100 [--ckpt-dir out/semla | --ref-ckpt last.ckpt] [--out mols/]
  python -m reed_tpu_torch.cli train-molecule-edm --steps 100 --synthetic \\
      [--data-dir qm9/] [--set probabilistic_model=fm] [--ckpt-dir out/edm --ckpt-every 1000]
  python -m reed_tpu_torch.cli eval-molecule --num-steps 1000 --n-replicates 3 \\
      [--ckpt-dir out/edm | --ref-ckpt generative_model_ema.npy] [--data-dir qm9/] \\
      [--rdm-ref-ckpt rdm.ckpt] [--out mols/]
  python -m reed_tpu_torch.cli train-rdm --steps 100 --synthetic [--data-dir reps/] \\
      [--ckpt-dir out/rdm --ckpt-every 1000]
  python -m reed_tpu_torch.cli train-multiflow --steps 100 --synthetic [--data-dir pdbs/] \\
      [--ref-ckpt last.ckpt] [--ckpt-dir out/mf --ckpt-every 1000] \\
      [--set compute_dtype=bfloat16]
  python -m reed_tpu_torch.cli eval-multiflow --num-samples 4 --length 64 \\
      --num-steps 100 [--ckpt-dir out/mf | --ref-ckpt last.ckpt] [--out pdbs_out/]
  python -m reed_tpu_torch.cli train-property --property alpha --steps 100 --synthetic \\
      [--data-dir qm9/] [--linear-probe] [--ckpt-dir out/clf --ckpt-every 1000]
  python -m reed_tpu_torch.cli eval-conditional --property alpha --n-samples 64 \\
      --num-steps 50 --ckpt-dir out/edm_cond --classifier-ckpt out/clf [--data-dir qm9/] \\
      [--sweep] [--out mols/]

Runs on CUDA unless `--device cpu` is given. Every subcommand but
compute-fid runs over the ranks torchrun launches with --distributed (NCCL
with one card a rank; gloo with --device cpu), laid out on reed_tpu's mesh
(--dp D x --fsdp F x --sp S x --tp T ranks): each batch splits over the D x
F batch indices (--batch-size, --n-samples and --num-samples are global)
and each group of T ranks splits the model (Megatron's tensor
parallelism): SiT's heads and MLP (train-image, generate-image),
ProteinMPNN's message chains and MLPs (train-protein, eval-protein),
SemlaFlow's message MLPs, attention heads and feed-forwards
(train-molecule-semla, eval-semla, arch semla; the egnn and eqgat archs run
whole on every tensor rank), the EGNN's MLPs (train-molecule-edm,
train-property, eval-molecule, eval-conditional: the EDM and the
classifier; --linear-probe runs whole on every tensor rank), the IPA heads
and sequence transformer (train-multiflow, eval-multiflow) and the RDM's
residual blocks (train-rdm). --sp S (each group of S ranks splits the
tokens) runs on SiT alone; every other subcommand raises on it. The
train-* subcommands hold the model and its optimizer state once a data
index (--fsdp shards the parameters at rest, Adam's moments, the
accumulation buffer and the EMA over groups of F ranks, gathering the
parameters where the model reads them) and need the batch to divide;
rank 0 writes the checkpoints, config.json, metrics.jsonl and the `[step
N]` lines. The eval subcommands
draw every random number at the global batch, as generate-image does, so a
sharded run equals one process's; their batches need not divide (the
first batch indices take a row more, as np.array_split splits, and one
with none joins the gathers), and rank 0 alone scores the gathered
samples, prints and writes. Configurations resolve as
reed_tpu's: the dataclass defaults, then `--config` (a JSON tree such as
recipes/image_sitxl_reed.json), then the explicit flags, then `--set`.
generate-image and train-image use reed_tpu's image default
(ImageTrainConfig): SiT-B/2 on 32x32x4 latents, 1000 classes, bf16 compute
with f32 master weights, one DINOv2-width projector at depth 8, Adam lr
1e-4, batch 256. eval-protein and train-protein use its protein default
(ProteinTrainConfig): ProteinMPNN-FMIF, hidden 128, 3 + 3 layers, 30
neighbours, f32 compute; training adds dropout 0.1, the AF3 alignment loss
and Adam with a global-norm clip. `--ckpt-dir` with `--ckpt-every` saves
and resumes training (core/checkpoint.py); on generate-image,
eval-protein and eval-semla it samples from the latest checkpoint's EMA
weights. train-molecule-semla and eval-semla use reed_tpu's SemlaFlow
default (SemlaTrainConfig): d_model 384, 12 layers, 64 coordinate sets, 32
heads, self-conditioning, REPA at depth 4 against 512-d reps, f32.
train-molecule-edm and eval-molecule use its EDM default
(MoleculeEDMConfig): the reference QM9 recipe, EGNN hidden 256 x 9 blocks,
attention, tanh, 5 atom types plus charges, max_nodes 29, 256-d rep
conditioning with rep dropout 0.1, EDM (or `--set probabilistic_model=fm`),
batch 64, Adam lr 1e-4, f32. train-rdm uses its RDM default
(RDMTrainConfig): SimpleMLP over 256-d reps, width 1536 x 18 blocks,
atom-count classes up to 256, x0-parameterised DDPM over T = 1000, AdamW
lr 1e-4 with weight decay 0.005 and a cosine decay, batch 128, f32.
train-multiflow and eval-multiflow use its MultiFlow default
(MultiflowTrainConfig): the IPA trunk at c_s 256, c_z 128, 6 blocks (IPA 8
heads, 8 query/key and 12 value points), a 2-layer sequence transformer a
block, batch 4 x max_len 128, the batch-OT translation prior, Adam lr
1e-4, f32. `--set compute_dtype=bfloat16` trains the protein, SemlaFlow,
EDM and MultiFlow models in bf16 with f32 master weights. train-property
uses its PropertyTrainConfig: the EGNN regressor at hidden 128 x 7
layers with edge attention, batch 96 x 29 atoms, Adam lr 1e-3 with a
cosine decay, the L1 loss on the mad-normalised property, f32 (or with
--linear-probe a Linear(rep_dim, 1) on reps.npy). eval-conditional samples
MoleculeEDMConfig's model with context_node_nf 1 and T = --num-steps and
scores it with the classifier's EMA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from reed_tpu_torch import resolve_device, synchronize
from reed_tpu_torch.core import configlib
from reed_tpu_torch.parallel.mesh import (EGNN_AXES, IPA_AXES, PMPNN_AXES, RDM_AXES,
                                         SEMLA_AXES, SIT_AXES, local_batch, shard_state_dict,
                                         whole_copy, whole_params)


def _resolve_cfg(cls, args, flags, defaults=None):
    """defaults <- --config file <- the explicit flags given (and the mesh
    flags) <- --set. With --distributed, joins torchrun's process group
    first (parallel.mesh.init_distributed); the mesh must fit the ranks
    that run (parallel.mesh.check_mesh, with the subcommand's model axes)."""
    from reed_tpu_torch.parallel import mesh as meshlib

    if args.distributed:
        device, dp = meshlib.init_distributed(args.device)
        print(f"distributed: process {dp.rank}/{dp.world}, 1 local / {dp.world} global "
              f"devices ({dp.backend}, {device})")
    cfg = configlib.build(cls, defaults or {})
    if args.config:
        cfg = configlib.merge(cfg, configlib.load_file(args.config))
    flags = dict(flags, mesh=_mesh_flags(args))
    cfg = configlib.merge(cfg, {k: v for k, v in flags.items() if v is not None})
    cfg = configlib.apply_overrides(cfg, args.overrides)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    meshlib.check_mesh(cfg.mesh, world, axes=args.model_axes)
    return cfg


def _mesh_flags(args):
    """--dp/--fsdp/--tp/--sp as reed_tpu reads them into MeshConfig (None
    where none is given)."""
    mesh = {k: v for k, v in (("data", args.dp), ("fsdp", args.fsdp), ("tensor", args.tp),
                              ("seq", args.sp)) if v is not None}
    return mesh or None


def _load_ema(model, ckpt_dir: str, shard=None):
    """Copy the latest checkpoint's EMA weights into `model`'s parameters
    (through `shard`, a function of the whole state_dict, where given)."""
    from reed_tpu_torch.core.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    ema = mgr.load_ema()
    if shard is not None:
        ema = shard(ema)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ema[name])
    print(f"loaded EMA weights of step {mgr.latest_step()} from {ckpt_dir}")


def generate_image(args):
    """FID sample generation: sample latents, decode them to 256x256 uint8
    pixels with the SD-VAE decoder on the device (--vae), and write an
    ADM-suite npz (arr_0)."""
    from reed_tpu_torch.encoders.sit_convert import load_reference_checkpoint
    from reed_tpu_torch.eval.fid import (FIDGenConfig, generate_samples,
                                         make_vae_decode_fn, strip_projector_params)
    from reed_tpu_torch.ops import flash_attention
    from reed_tpu_torch.parallel.mesh import SIT_TP_RULES, data_parallel, shard_state_dict
    from reed_tpu_torch.train.image import ImageTrainConfig, build_model

    device = resolve_device(args.device)
    # torch-parity inference from a reference checkpoint needs erf GELU
    cfg = _resolve_cfg(ImageTrainConfig, args,
                       {"model": args.model, "seed": args.seed, "compute_dtype": args.dtype},
                       defaults={"exact_gelu": True} if args.ref_ckpt else None)
    parallel = data_parallel(cfg.mesh, axes=SIT_AXES)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(cfg.seed),
                        parallel=parallel)
    if args.ref_ckpt:
        sd = shard_state_dict(strip_projector_params(
            load_reference_checkpoint(args.ref_ckpt)), parallel, SIT_TP_RULES)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.startswith("projectors.")]
        if missing or unexpected:
            raise ValueError(f"checkpoint {args.ref_ckpt} does not fit "
                             f"{cfg.model}: missing {missing}, "
                             f"unexpected {unexpected}")
        print(f"loaded reference checkpoint {args.ref_ckpt} (exact_gelu={cfg.exact_gelu})")
    elif args.ckpt_dir:
        _load_ema(model, args.ckpt_dir,
                  shard=lambda sd: shard_state_dict(sd, parallel, SIT_TP_RULES))
    model = model.to(getattr(torch, cfg.compute_dtype))
    calls = 0

    def model_fn(x, t, y):
        nonlocal calls
        calls += 1
        return model(x, t, y)[0]

    decode_fn = make_vae_decode_fn(args.vae, device=device)
    if decode_fn is None:
        print("WARNING: no --vae decoder npz given; npz will hold raw latents, not "
              "the 256x256 uint8 pixels the ADM FID suite expects (convert with "
              "tools/convert_vae.py)")
    gen_cfg = FIDGenConfig(num_samples=args.num_samples,
                           batch_size=args.batch_size or 64,
                           num_classes=cfg.num_classes,
                           latent_size=cfg.input_size,
                           latent_channels=cfg.in_channels,
                           mode=args.mode, num_steps=args.num_steps,
                           cfg_scale=args.cfg_scale,
                           guidance_low=args.guidance_low,
                           guidance_high=args.guidance_high, seed=cfg.seed)
    before = flash_attention.launches
    generate_samples(model_fn, gen_cfg, device=device, out_npz=args.out,
                     decode_fn=decode_fn, mesh=cfg.mesh)
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        print(f"flash_attention launches: {flash_attention.launches - before} in {calls} "
              f"model calls ({cfg.model}, {cfg.compute_dtype}, {device})")


def compute_fid(args):
    """FID between two inputs, each a stats npz ({mu, sigma}) or an
    ADM-style image npz (uint8 [N, H, W, 3] under arr_0, samples or
    images: the file generate-image writes). Image inputs are featurized
    by the InceptionV3 pool3 network of --inception-npz on the device."""
    from reed_tpu_torch.eval.frechet import compute_activation_stats, frechet_distance

    device = resolve_device(args.device)
    feature_fn = None

    def stats_for(path):
        nonlocal feature_fn
        data = np.load(path)
        if "mu" in data.files and "sigma" in data.files:
            return {"mu": data["mu"], "sigma": data["sigma"]}
        key = next(k for k in ("arr_0", "samples", "images") if k in data.files)
        if feature_fn is None:
            if not args.inception_npz:
                raise SystemExit(
                    "--inception-npz required to featurize image npz (convert once: "
                    "reed_tpu/encoders/inception.py load_torch_inception_checkpoint "
                    "+ save_variables_npz)")
            from reed_tpu_torch.encoders.inception import load_npz, make_feature_fn

            feature_fn = make_feature_fn(load_npz(args.inception_npz, device=device))
        stats = compute_activation_stats(data[key], feature_fn, batch_size=args.batch_size)
        if args.save_stats:
            out = os.path.splitext(path)[0] + "_stats.npz"
            np.savez(out, **stats)
            print(f"saved stats to {out}")
        return stats

    s1, s2 = stats_for(args.ref), stats_for(args.gen)
    fid = frechet_distance(s1["mu"], s1["sigma"], s2["mu"], s2["sigma"])
    print(json.dumps({"fid": fid}))
    return fid


@contextlib.contextmanager
def _main_prints(dp):
    """Under a process group every rank but process rank 0 prints nothing
    inside the block: rank 0 alone reports, scores and writes."""
    if dp is None or dp.is_main:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def _ranks(dp) -> str:
    """The ranks a sharded eval runs on, for its speed line."""
    if dp is None:
        return "1 process"
    return (f"{dp.world * dp.seq * dp.tensor} ranks: {dp.world} batch indices x tensor "
            f"{dp.tensor}")


def eval_protein(args):
    """Inverse-folding eval: Euler-unmask sampling conditioned on backbones
    and sequence recovery against the native sequence, on a synthetic batch
    or on the valid split under --data-dir. Under --distributed each batch
    splits over the data x fsdp batch indices (batches need not divide) and
    the tensor ranks split the model (PMPNN_TP_RULES); rank 0 scores the
    gathered batch."""
    from reed_tpu_torch.eval.protein_metrics import (sequence_recovery,
                                                     tokens_to_sequence)
    from reed_tpu_torch.parallel.mesh import PMPNN_TP_RULES, data_parallel, run_rows
    from reed_tpu_torch.train.protein import (ProteinTrainConfig, build_model,
                                              sample, synthetic_protein_batch)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(ProteinTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "compute_dtype": args.dtype, "fused_messages": args.fused_messages},
                       defaults={"batch_size": 4})
    cfg = configlib.merge(cfg, {"interpolant": {"num_timesteps": args.num_steps}})
    dp = data_parallel(cfg.mesh, axes=PMPNN_AXES)

    def shard(sd):
        return shard_state_dict(sd, dp, PMPNN_TP_RULES)

    with _main_prints(dp):
        model = build_model(cfg, device=device, parallel=dp,
                            generator=torch.Generator(device=device).manual_seed(cfg.seed))
        if args.ref_ckpt:
            from reed_tpu_torch.encoders.fmif_convert import load_reference_checkpoint

            # model flags must match the checkpoint (--set)
            model.load_state_dict(shard(load_reference_checkpoint(args.ref_ckpt)))
            print(f"loaded reference checkpoint {args.ref_ckpt}")
        elif args.ckpt_dir:
            _load_ema(model, args.ckpt_dir, shard=shard)

        def run(batch):
            """(pred, tokens) of one global batch, with its seconds to the last
            token (this rank's rows sampled, every row gathered)."""
            synchronize(device)
            t0 = time.perf_counter()
            pred, tokens = run_rows(dp, batch["S"].shape[0], batch, lambda rows: sample(
                model, rows, torch.Generator(device=device).manual_seed(cfg.seed + 1),
                cfg.interpolant))
            synchronize(device)
            return pred.cpu().numpy(), tokens.cpu().numpy(), time.perf_counter() - t0

        def report_speed(n_seqs, n_batches, seconds):
            steps = n_batches * (cfg.interpolant.num_timesteps - 1)
            print(f"{n_seqs / seconds:.3f} sequences/s, {1e3 * seconds / max(steps, 1):.3f} "
                  f"ms per decoder step (encoder once per batch included; "
                  f"{n_batches} batches, {device}, {cfg.compute_dtype}, "
                  f"fused={model.fused}, {_ranks(dp)})")

        if args.data_dir:
            from reed_tpu_torch.data.protein import (PDBParams, build_training_clusters,
                                                     sample_cluster_chains,
                                                     token_bucket_batches)

            params = PDBParams(args.data_dir)
            _, valid_clusters, _ = build_training_clusters(params)
            entries = sample_cluster_chains(np.random.default_rng(cfg.seed),
                                            valid_clusters, params,
                                            max_length=cfg.max_len,
                                            limit=args.max_chains)
            if not entries:
                raise SystemExit(f"no valid-split chains under {args.data_dir}")
            recs, weights, sample_seq = [], [], None
            n_seqs, n_batches, seconds = 0, 0, 0.0
            for arrays in token_bucket_batches(entries):
                batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
                pred, tokens, sec = run(batch)
                n_seqs, n_batches, seconds = n_seqs + len(pred), n_batches + 1, seconds + sec
                m = arrays["mask"] * arrays["chain_M"]
                recs.append(sequence_recovery(pred, arrays["S"], m))
                weights.append(m.sum())
                if sample_seq is None:
                    sample_seq = tokens_to_sequence(tokens[0], arrays["mask"][0])
            report_speed(n_seqs, n_batches, seconds)
            out = {"split": "valid", "num_chains": len(entries),
                   "sequence_recovery": float(np.average(recs, weights=weights)),
                   "sample_0": sample_seq[:80]}
        else:
            batch = synthetic_protein_batch(
                torch.Generator(device=device).manual_seed(cfg.seed), cfg.batch_size,
                args.length)
            pred, tokens, seconds = run(batch)
            report_speed(len(pred), 1, seconds)
            mask = (batch["mask"] * batch["chain_M"]).cpu().numpy()
            out = {"split": "synthetic",
                   "sequence_recovery": sequence_recovery(pred, batch["S"].cpu().numpy(),
                                                          mask),
                   "sample_0": tokens_to_sequence(tokens[0],
                                                  batch["mask"][0].cpu().numpy())[:80]}
        print(json.dumps(out, indent=2))
    return out if dp is None or dp.is_main else None


def _start_profile(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, device, profile_dir, first, last):
    """Stop a trace after the device has finished the traced steps and write
    it as {profile_dir}/steps_{first}-{last}.pt.trace.json."""
    synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"steps_{first}-{last}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace -> {path}")


def _run_loop(trainer, state, batches, args, samples_of, cfg, label, unit,
              sample_hook=None):
    """reed_tpu's training loop: `args.steps` steps over `batches` (this
    rank's rows under a process group; each fetch and step inside the
    profiler ranges `reed::next_batch` and `reed::train_step`), logging
    `[step N] {...}` every --log-every steps (and to
    {ckpt_dir}/metrics.jsonl), saving every --ckpt-every steps under
    --ckpt-dir after resuming from its latest checkpoint (with a config
    snapshot beside it), calling
    `sample_hook(state, step)` every --sample-every steps; then the rate of
    the steps after the first. `samples_of(batch)` counts the global
    batch's samples, in `unit`s, from this rank's rows. With --profile-dir,
    torch.profiler traces the steps reed_tpu traces (from min(2, max(0,
    steps - 2)) through min(7, steps - 1), the device synchronised before
    the stop) and writes a Chrome trace into that directory. Under a
    process group (trainer.dp) rank 0 alone prints, writes config.json,
    metrics.jsonl, the checkpoints and the trace; every rank resumes."""
    from reed_tpu_torch.core.checkpoint import CheckpointManager
    from reed_tpu_torch.core.logging import MetricLogger

    device, dp = trainer.device, trainer.dp
    main = dp is None or dp.is_main
    logger = MetricLogger(log_dir=args.ckpt_dir if main else None, stdout=main)
    if args.ckpt_dir and main:
        print(f"config snapshot -> {configlib.snapshot(cfg, args.ckpt_dir)}")
    if dp is not None:
        dp.barrier()
    ckpt = None
    if args.ckpt_dir and args.ckpt_every:
        ckpt = CheckpointManager(args.ckpt_dir, save_interval_steps=args.ckpt_every, dp=dp)
        if ckpt.latest_step() is not None:
            ckpt.restore(state, trainer.generator)
            if main:
                print(f"resumed from step {state.step}")
    t0 = samples = None
    profile_dir = getattr(args, "profile_dir", None) if main else None
    prof = None
    profile_start = min(2, max(0, args.steps - 2))
    profile_stop = min(7, args.steps - 1)  # always stop before the loop ends
    for i in range(args.steps):
        if profile_dir and i == profile_start:
            prof = _start_profile(device)
        with record_function("reed::next_batch"):
            batch = next(batches)
        with record_function("reed::train_step"):
            state, metrics = trainer.train_step(state, batch)
        if prof is not None and i >= profile_stop:
            _stop_profile(prof, device, profile_dir, profile_start, i)
            prof = None
        if i == 0:
            synchronize(device)
            t0, samples = time.perf_counter(), 0
        else:
            samples += samples_of(batch)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            logger.log(metrics, state.step, samples_per_step=samples_of(batch))
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(state, trainer.generator)
        if sample_hook is not None and (i + 1) % args.sample_every == 0:
            sample_hook(state, state.step)
    if ckpt:
        ckpt.save(state, trainer.generator)
    logger.close()
    synchronize(device)
    if args.steps > 1 and main:
        seconds = time.perf_counter() - t0
        n = args.steps - 1
        print(f"{label}: {n} steps after the first in {seconds:.3f} s: "
              f"{n / seconds:.3f} steps/s, {samples / seconds:.2f} {unit}/s")
    return state


def _global_rows(trainer, key):
    """samples_of for _run_loop: the rows of batch[key] over every rank
    (the ranks hold equal shares of the global batch)."""
    world = 1 if trainer.dp is None else trainer.dp.world
    return lambda batch: int(batch[key].shape[0]) * world


def train_protein(args):
    """Train ProteinMPNN-FMIF on synthetic batches (batch_size x max_len,
    with AF3-style embeddings) or on the train split under --data-dir,
    logging `[step N] {...}` every --log-every steps."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

    device = resolve_device(args.device)
    cfg = _resolve_cfg(ProteinTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None})
    trainer = ProteinTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        from reed_tpu_torch.encoders.fmif_convert import load_reference_checkpoint
        from reed_tpu_torch.parallel.mesh import PMPNN_TP_RULES, shard_state_dict

        # warm start from a reference fmif checkpoint (train_fmif.py:225-237),
        # a tensor rank's shards of it
        with whole_params(state.opt.plan, write=True):
            state.model.load_state_dict(shard_state_dict(
                load_reference_checkpoint(args.ref_ckpt), trainer.dp, PMPNN_TP_RULES))
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype, state.opt.plan)
        print(f"warm-started from reference checkpoint {args.ref_ckpt}")

    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield trainer.synthetic_batch(
                    torch.Generator(device=device).manual_seed(cfg.seed + 1000 + i))
                i += 1
    else:
        from reed_tpu_torch.data.protein import (BufferPool, PDBParams,
                                                 build_training_clusters,
                                                 sample_cluster_chains,
                                                 token_bucket_batches)

        repr_dir = os.path.join(args.data_dir, "repr")
        params = PDBParams(args.data_dir,
                           repr_dir=repr_dir if os.path.isdir(repr_dir) else None)
        train_clusters, _, _ = build_training_clusters(params)
        repr_dims = {"single": cfg.single_dim, "pair": cfg.pair_dim,
                     "structure": cfg.structure_dim}
        if params.repr_dir is None and cfg.load_repr:
            print("WARNING: no repr/ dir under --data-dir; AF3 alignment targets "
                  "are zero-filled")
        # featurize writes into recycled buffers; the loop holds one batch at
        # a time (copied to the device), so a depth of 2 is enough
        pool = BufferPool(depth=2)

        def batches():
            epoch = 0
            while True:
                rng = np.random.default_rng(cfg.seed + epoch)
                entries = sample_cluster_chains(rng, train_clusters, params,
                                                max_length=cfg.max_len)
                if not entries:
                    raise SystemExit(f"no train-split chains under {args.data_dir}")
                for arrays in token_bucket_batches(entries, token_budget=args.token_budget,
                                                   repr_dims=repr_dims, shuffle_rng=rng,
                                                   pool=pool):
                    yield {k: torch.from_numpy(v).to(device)
                           for k, v in local_batch(trainer.dp, arrays).items()}
                epoch += 1

    return _run_loop(trainer, state, batches(), args, _global_rows(trainer, "S"),
                     cfg, f"train-protein ({device})", "sequences")


def train_image(args):
    """Train SiT with REED alignment on synthetic batches (N(0, 1) latents
    and encoder targets) or on the cached latents under --data-dir, with
    the frozen encoders of --enc-type computing their targets from the raw
    pixel crops in the loop (profiler range `reed::frozen_encoder`); logging `[step N] {...}` every --log-every
    steps, previews every --sample-every steps, then the rate of the steps
    after the first (steps/s and imgs/s)."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.train.image import ImageTrainConfig, ImageTrainer

    device = resolve_device(args.device)
    cfg = _resolve_cfg(ImageTrainConfig, args,
                       {"model": args.model, "batch_size": args.batch_size,
                        "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None},
                       defaults={"exact_gelu": True} if args.ref_ckpt else None)
    trainer = ImageTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        from reed_tpu_torch.encoders.sit_convert import load_reference_checkpoint
        from reed_tpu_torch.parallel.mesh import SIT_TP_RULES, shard_state_dict

        # warm start from a reference torch checkpoint (forces exact_gelu)
        with whole_params(state.opt.plan, write=True):
            state.model.load_state_dict(shard_state_dict(
                load_reference_checkpoint(args.ref_ckpt), trainer.dp, SIT_TP_RULES))
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype, state.opt.plan)
        print(f"warm-started from reference checkpoint {args.ref_ckpt}")

    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield trainer.synthetic_batch(
                    torch.Generator(device=device).manual_seed(cfg.seed + 1000 + i))
                i += 1
    else:
        from reed_tpu_torch.data.image import (CachedLatentDataset,
                                               ImageDatasetConfig, epoch_batches)

        encoders = None
        ds_cfg = ImageDatasetConfig(args.data_dir)
        if args.enc_type:
            # in-loop frozen-encoder targets from the raw pixel crops
            from reed_tpu_torch.encoders.registry import encode_features, load_encoders

            encoders, _, _ = load_encoders(args.enc_type, encoder_dir=args.encoder_dir,
                                           device=device)
            ds_cfg = ImageDatasetConfig(args.data_dir, pixels_subdir=args.pixels_subdir)
        # without feature subdirectories or encoders zs is empty and
        # proj_loss is 0, as in reed_tpu's train-image
        ds = CachedLatentDataset(ds_cfg)
        if len(ds) < cfg.batch_size:
            raise SystemExit(f"{len(ds)} samples under {args.data_dir}, fewer "
                             f"than one batch of {cfg.batch_size}")
        # reed_tpu's per-process pipeline: each rank reads its own stride
        # of the shuffled samples, batch_size / world of them a step
        rank, world = (0, 1) if trainer.dp is None else (trainer.dp.rank, trainer.dp.world)

        def batches():
            epoch = 0
            while True:
                for batch in epoch_batches(ds, cfg.batch_size // world, cfg.seed + epoch,
                                           process_index=rank, process_count=world):
                    if encoders is not None:
                        with record_function("reed::frozen_encoder"):
                            feats = encode_features(encoders, batch.pop("pixels"))
                        batch["zs"] = feats + list(batch["zs"])
                    yield batch
                epoch += 1

    sample_hook = None
    if args.sample_every:
        sample_hook = _preview_hook(cfg, args, device, trainer.dp)
    return _run_loop(trainer, state, batches(), args, lambda b: cfg.batch_size, cfg,
                     f"train-image ({cfg.model}, batch {cfg.batch_size}, "
                     f"{cfg.compute_dtype}, {device})", "imgs", sample_hook=sample_hook)


def _preview_hook(cfg, args, device, dp):
    """sample_hook(state, step): 16 samples from the EMA weights (ODE, 50
    steps, CFG 4.0, seeded by the step; sharded over the ranks under a
    process group), VAE-decoded where --vae is given, else the first three
    latent channels scaled to [0, 255], saved by rank 0 as a grid
    {ckpt_dir or .}/preview_{step:07d}.png."""
    from reed_tpu_torch.core.ema import ema_weights
    from reed_tpu_torch.eval.fid import FIDGenConfig, generate_samples, make_vae_decode_fn
    from reed_tpu_torch.eval.visualize import save_image_grid

    decode_fn = make_vae_decode_fn(args.vae, device=device)
    ema_model = None

    def hook(state, step):
        nonlocal ema_model
        if ema_model is None:
            ema_model = whole_copy(state.model, state.opt.plan).eval()
        with torch.no_grad():
            ema = ema_weights(state)
            for name, p in ema_model.named_parameters():
                p.copy_(ema[name])
        gen_cfg = FIDGenConfig(num_samples=16, batch_size=16, mode="ode", num_steps=50,
                               cfg_scale=4.0, num_classes=cfg.num_classes,
                               latent_size=cfg.input_size,
                               latent_channels=cfg.in_channels, seed=step)
        out = generate_samples(lambda x, t, y: ema_model(x, t, y)[0], gen_cfg,
                               device=device, decode_fn=decode_fn, mesh=cfg.mesh)
        if decode_fn is None:
            vis = out[..., :3]
            vis = (vis - vis.min()) / (vis.max() - vis.min() + 1e-8)
            out = (vis * 255).astype(np.uint8)
        if dp is None or dp.is_main:
            path = f"{args.ckpt_dir or '.'}/preview_{step:07d}.png"
            save_image_grid(path, out)
            print(f"saved sample preview -> {path}")

    return hook


def _find_split(data_dir: str, split: str) -> str:
    """A split file: <dir>/<split>.rsmol[.npz] or <dir>/<split>.npz, or
    `data_dir` itself when it is a file."""
    if os.path.isfile(data_dir):
        return data_dir
    for ext in (".rsmol", ".rsmol.npz", ".npz"):
        path = os.path.join(data_dir, split + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {split}.rsmol[.npz] or {split}.npz under {data_dir}")


def _load_reps(data_dir: str, d_rep, n: int, key: str = "d_rep"):
    """Precomputed frozen-encoder reps aligned with the dataset (reps.npy or
    train_reps.npy beside the split), or zeros with a warning where there
    are none; None where the model takes no rep (config field `key`)."""
    if d_rep is None:
        return None
    if os.path.isfile(data_dir):
        data_dir = os.path.dirname(data_dir)
    for name in ("reps.npy", "train_reps.npy"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            reps = np.load(path)
            if reps.shape != (n, d_rep):
                raise ValueError(f"{path}: reps of shape {reps.shape}, the dataset "
                                 f"needs ({n}, {d_rep})")
            return reps.astype(np.float32)
    print(f"WARNING: no reps.npy in {data_dir}; rep conditioning/alignment will see "
          f"zeros (train with --set {key}=null to silence)")
    return np.zeros((n, d_rep), np.float32)


def _semla_ref_ckpt(model, path, parallel=None):
    """Load a reference SemlaFlow checkpoint (EMA weights where present),
    a tensor rank's shards of it under `parallel`."""
    from reed_tpu_torch.encoders.semla_convert import load_into, load_torch_semla_checkpoint
    from reed_tpu_torch.parallel.mesh import SEMLA_TP_RULES, shard_state_dict

    load_into(model, shard_state_dict(load_torch_semla_checkpoint(path), parallel,
                                      SEMLA_TP_RULES))


def train_molecule_semla(args):
    """Train SemlaFlow on synthetic batches (reed_tpu's example_batch, 32
    atoms) or on the .rsmol train split under --data-dir (size-bucketed
    batches of --batch-cost padded atoms, OT-coupled and interpolated on the
    host, with reps.npy beside it), logging `[step N] {...}` every
    --log-every steps, then the rate of the steps after the first."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.train.molecule_semla import (SemlaTrainConfig, SemlaTrainer,
                                                     batch_to_device)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(SemlaTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None})
    trainer = SemlaTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        with whole_params(state.opt.plan, write=True):
            _semla_ref_ckpt(state.model, args.ref_ckpt, trainer.dp)
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype, state.opt.plan)
        print(f"warm-started from reference checkpoint {args.ref_ckpt}")

    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield batch_to_device(local_batch(
                    trainer.dp, trainer.example_batch(cfg.batch_size, 32, seed=i)), device)
                i += 1
    else:
        from reed_tpu_torch.data.molecule import (GEOM_COORDS_STD_DEV, QM9_COORDS_STD_DEV,
                                                  load_dataset, mol_transform,
                                                  semla_epoch_batches)

        coord_std = (args.coord_std if args.coord_std is not None
                     else GEOM_COORDS_STD_DEV if args.dataset == "geom"
                     else QM9_COORDS_STD_DEV)
        mols = [mol_transform(m, coord_std)
                for m in load_dataset(_find_split(args.data_dir, "train"))]
        reps = _load_reps(args.data_dir, cfg.d_rep, len(mols))
        print(f"loaded {len(mols)} molecules from {args.data_dir}")

        def batches():
            epoch = 0
            while True:
                rng = np.random.default_rng(cfg.seed + epoch)
                for batch in semla_epoch_batches(
                        mols, cfg.interpolant, rng, reps=reps, batch_cost=args.batch_cost,
                        vocab_size=cfg.vocab_size, n_bond_types=cfg.n_bond_types,
                        n_charge_types=cfg.n_charge_types):
                    yield batch_to_device(local_batch(trainer.dp, batch), device)
                epoch += 1

    return _run_loop(trainer, state, batches(), args, _global_rows(trainer, "times"), cfg,
                     f"train-molecule-semla ({device})", "molecules")


def eval_semla(args):
    """SemlaFlow generation eval: --n-replicates x --n-samples molecules of
    --n-atoms-min..max atoms (each batch padded to cfg.max_atoms, as
    reed_tpu's), integrated from the prior in --num-steps steps and scored
    over the predicted graphs (GraphMoleculeMetrics), mean and std over the
    replicates (reference protocol: molecule/semlaflow/evaluate.py:22-120).
    Prints molecules/s and ms per integrator step, then the JSON summary;
    --out writes replicate 0 as .xyz and predicted-bond .sdf files. Under
    --distributed each batch (the prior and reps drawn for the whole batch
    on every rank) splits over the data x fsdp batch indices and the tensor
    ranks split arch semla (SEMLA_TP_RULES; egnn and eqgat run whole on
    every tensor rank); rank 0 scores and writes the gathered molecules."""
    from reed_tpu_torch.data.molecule import CORE_ATOMS, OTHER_ATOMS
    from reed_tpu_torch.eval.molecule_metrics import (SEMLA_IDX_CHARGES,
                                                      GraphMoleculeMetrics)
    from reed_tpu_torch.eval.visualize import save_sdf_file, save_xyz_file
    from reed_tpu_torch.parallel.mesh import SEMLA_TP_RULES, data_parallel, run_rows
    from reed_tpu_torch.train.molecule_semla import (SemlaTrainConfig, build_model, generate,
                                                     sample_prior)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(SemlaTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed},
                       defaults={"batch_size": 16})
    cfg = configlib.merge(cfg, {"integrator": {"steps": args.num_steps}})
    dp = data_parallel(cfg.mesh, axes=SEMLA_AXES)
    main = dp is None or dp.is_main
    with _main_prints(dp):
        model = build_model(cfg, device=device, parallel=dp,
                            generator=torch.Generator(device=device).manual_seed(cfg.seed))
        if args.ref_ckpt:
            _semla_ref_ckpt(model, args.ref_ckpt, dp)
            print(f"loaded reference checkpoint {args.ref_ckpt}")
        elif args.ckpt_dir:
            _load_ema(model, args.ckpt_dir,
                      shard=lambda sd: shard_state_dict(sd, dp, SEMLA_TP_RULES))
        model.eval()

        # the default decoder is the semla vocab (PAD/MASK + 16 elements); a
        # molecule with a PAD/MASK type scores as invalid
        if args.atom_decoder:
            decoder, first_real = tuple(args.atom_decoder.split(",")), 0
        else:
            decoder, first_real = tuple(["H", "H"] + CORE_ATOMS + OTHER_ATOMS), 2
        metrics_eval = GraphMoleculeMetrics(atom_decoder=decoder, dataset=args.dataset)
        charge_map = np.asarray(SEMLA_IDX_CHARGES, np.int64)
        # scored in place of a molecule with PAD/MASK predictions: two distant
        # unbonded H atoms (unstable, disconnected, invalid)
        invalid_mol = (np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]], np.float32),
                       np.array([decoder.index("H")] * 2), np.zeros((2, 2), np.int64),
                       np.zeros(2, np.int64))
        coord_std = args.coord_std if args.coord_std is not None else 1.0

        def run(batch, seed):
            """The final molecules of one global batch (this rank's rows
            integrated)."""
            return run_rows(dp, batch["prior"]["coords"].shape[0], batch, lambda rows: generate(
                model, cfg, rows["prior"], rep=rows["rep"],
                sampling_strategy=args.sampling_strategy,
                generator=torch.Generator(device=device).manual_seed(seed)))

        replicates, n_mols, n_batches, seconds = [], 0, 0, 0.0
        for rep_i in range(args.n_replicates):
            rng_np = np.random.default_rng(1000 + rep_i)
            mols, done = [], 0
            while done < args.n_samples:
                bs = min(cfg.batch_size, args.n_samples - done)
                sizes = rng_np.integers(args.n_atoms_min, args.n_atoms_max + 1, size=bs)
                mask = (np.arange(cfg.max_atoms)[None, :] < sizes[:, None]).astype(np.float32)
                prior = sample_prior(cfg, rng_np, mask, device)
                rep = (torch.from_numpy(rng_np.standard_normal((bs, cfg.d_rep)).astype(
                    np.float32)).to(device) if cfg.d_rep and cfg.cond_type != "none" else None)
                synchronize(device)
                t0 = time.perf_counter()
                final = run({"prior": prior, "rep": rep}, rep_i * 1000 + done)
                out = {k: v.cpu().numpy() for k, v in final.items()}
                seconds += time.perf_counter() - t0
                n_mols, n_batches = n_mols + bs, n_batches + 1
                done += bs
                if not main:
                    continue
                coords = out["coords"] * coord_std
                types = np.argmax(out["atomics"], axis=-1)
                bonds = np.argmax(out["bonds"], axis=-1)
                charges = charge_map[np.argmax(out["charges"], axis=-1)]
                for b in range(bs):
                    n_b = sizes[b]
                    t_b = types[b, :n_b]
                    if (t_b < first_real).any() or (t_b >= len(decoder)).any():
                        mols.append(invalid_mol)
                    else:
                        mols.append((coords[b, :n_b], t_b, bonds[b, :n_b, :n_b],
                                     charges[b, :n_b]))
                    if args.out and rep_i == 0:
                        idx = done - bs + b
                        save_xyz_file(os.path.join(args.out, f"mol_{idx:04d}.xyz"),
                                      coords[b, :n_b], types[b, :n_b], decoder)
                        save_sdf_file(os.path.join(args.out, f"mol_{idx:04d}.sdf"),
                                      coords[b, :n_b], types[b, :n_b], bonds[b, :n_b, :n_b],
                                      decoder, name=f"mol_{idx}")
            if main:
                replicates.append(metrics_eval.evaluate(mols))

        print(f"{n_mols / seconds:.3f} molecules/s, "
              f"{1e3 * seconds / (n_batches * cfg.integrator.steps):.3f} ms per integrator "
              f"step ({n_batches} batches of up to {cfg.batch_size}, padded to max_atoms "
              f"{cfg.max_atoms}, {device}, {_ranks(dp)})")
        if not main:
            return None
        summary = {}
        for k in replicates[0]:
            vals = [r[k] for r in replicates]
            if isinstance(vals[0], bool):  # the 'rdkit' semantics marker
                summary[k] = vals[0]
                continue
            summary[k] = float(np.mean(vals))
            summary[f"{k}_std"] = float(np.std(vals))
        summary.update(n_replicates=args.n_replicates, n_samples=args.n_samples,
                       num_steps=args.num_steps)
        print(json.dumps(summary))
    return summary


def _edm_ref_ckpt(model, path, device, parallel=None):
    """Load a reference EDM checkpoint (generative_model[_ema].npy) into
    `model` (a tensor rank's shards of it under `parallel`); returns its
    learned noise schedule (a GammaNetwork on `device`) or None."""
    from reed_tpu_torch.diffusion.edm import GammaNetwork
    from reed_tpu_torch.encoders.edm_convert import load_into, load_torch_edm_checkpoint
    from reed_tpu_torch.parallel.mesh import EGNN_TP_RULES, shard_state_dict

    dyn, gamma_sd = load_torch_edm_checkpoint(path)
    load_into(model, shard_state_dict(dyn, parallel, EGNN_TP_RULES))
    if gamma_sd is None:
        return None
    gamma = GammaNetwork(hidden=gamma_sd["l2.weight"].shape[0]).to(device)
    load_into(gamma, gamma_sd)
    return gamma


def train_molecule_edm(args):
    """Train the EDM (or, with --set probabilistic_model=fm, the EFM)
    molecule model on synthetic batches (reed_tpu's synthetic_batch
    schema) or on the QM9 EDM npz train split under --data-dir (with
    reps.npy beside it), logging `[step N] {...}` every --log-every steps,
    then the rate of the steps after the first."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.train.molecule_edm import (MoleculeEDMConfig, MoleculeEDMTrainer,
                                                   batch_to_device)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(MoleculeEDMConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None})
    trainer = MoleculeEDMTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        with whole_params(state.opt.plan, write=True):
            _edm_ref_ckpt(state.model, args.ref_ckpt, device, trainer.dp)
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype, state.opt.plan)
        print(f"warm-started from reference checkpoint {args.ref_ckpt}")

    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield trainer.synthetic_batch(torch.Generator(device=device).manual_seed(i))
                i += 1
    else:
        from reed_tpu_torch.data.molecule import edm_epoch_batches, load_qm9_edm_npz

        data = load_qm9_edm_npz(_find_split(args.data_dir, "train"))
        reps = _load_reps(args.data_dir, cfg.rep_nf, len(data["positions"]), "rep_nf")
        print(f"loaded {len(data['positions'])} molecules from {args.data_dir}")

        def batches():
            epoch = 0
            while True:
                rng = np.random.default_rng(cfg.seed + epoch)
                for batch in edm_epoch_batches(
                        data, cfg.batch_size, rng, reps=reps, max_nodes=cfg.max_nodes,
                        num_atom_types=cfg.num_atom_types,
                        include_charges=cfg.include_charges):
                    yield batch_to_device(local_batch(trainer.dp, batch), device)
                epoch += 1

    return _run_loop(trainer, state, batches(), args, _global_rows(trainer, "node_mask"), cfg,
                     f"train-molecule-edm {cfg.probabilistic_model} ({device})", "molecules")


def _rdm_rep_sampler(path: str, cfg, device):
    """A DDIM rep sampler (eta 1, 250 steps) over the reference RDM
    checkpoint at `path`, its widths read off the checkpoint as reed_tpu's
    eval-molecule reads them, its class table padded to max_nodes + 1 rows."""
    from reed_tpu_torch.diffusion.rdm import RDMConfig, RDMDiffusion
    from reed_tpu_torch.encoders.rdm_convert import read_checkpoint, strip_state_dict, widths
    from reed_tpu_torch.eval.rep_samplers import DDIMRepSampler
    from reed_tpu_torch.models.rdm_mlp import SimpleMLP

    if cfg.rep_nf is None:
        raise ValueError("--rdm-ref-ckpt samples reps, but the model takes none (rep_nf null)")
    sd = strip_state_dict(read_checkpoint(path), num_rows=cfg.max_nodes + 1)
    w = widths(sd)
    if (w["in_channels"], w["out_channels"]) != (cfg.rep_nf, cfg.rep_nf):
        raise ValueError(f"{path}: an RDM over reps of width {w['in_channels']}, the model "
                         f"takes rep_nf {cfg.rep_nf}")
    with torch.device(device):
        model = SimpleMLP(**w, num_classes=cfg.max_nodes)
    model.load_state_dict(sd)
    model.eval()
    return DDIMRepSampler(RDMDiffusion(RDMConfig(channels=cfg.rep_nf),
                                       lambda x, t, n: model(x, t, n), device=device))


def eval_molecule(args):
    """Two-stage molecule eval (reference: molecule/eval_src/eval_analyze.py):
    a GtSampler over the reps.npy and sizes.npy under --data-dir (random
    stand-in reps and sizes without them) gives each molecule a rep; the EDM
    ancestral sampler (T = --num-steps; CFG where edm.cfg_scale is set) or
    the EFM decode generates --batch-size molecules a replicate from the
    EMA of --ckpt-dir's latest checkpoint or a reference checkpoint, scored
    by MoleculeMetrics with the mean and std over --n-replicates; with a
    test split under --data-dir, one more replicate against it by the MOSES
    metrics and the MiDi distances. Prints molecules/s and ms per sampler
    step, then reed_tpu's JSON; --out writes one more replicate as .xyz
    files and 3D PNG renders (the PNGs need matplotlib)."""
    from reed_tpu_torch.data.molecule import QM9_ATOM_DECODER
    from reed_tpu_torch.eval.molecule_metrics import (GEOM_ATOM_DECODER, DistributionNodes,
                                                      MoleculeMetrics)
    from reed_tpu_torch.eval.rep_samplers import GtSampler
    from reed_tpu_torch.eval.two_stage import (TwoStageSampler, evaluate_replicates,
                                               molecules_from_samples)
    from reed_tpu_torch.parallel.mesh import EGNN_TP_RULES, data_parallel
    from reed_tpu_torch.train.molecule_edm import (MoleculeEDMConfig, build_dynamics,
                                                   sample)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(MoleculeEDMConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed},
                       defaults={"batch_size": 16, "edm": {"timesteps": args.num_steps}})
    dp = data_parallel(cfg.mesh, axes=EGNN_AXES)
    main = dp is None or dp.is_main
    with _main_prints(dp):
        model = build_dynamics(cfg, device=device, parallel=dp,
                               generator=torch.Generator(device=device).manual_seed(cfg.seed))
        gamma = None
        if args.ref_ckpt:
            gamma = _edm_ref_ckpt(model, args.ref_ckpt, device, dp)
            print(f"loaded reference torch checkpoint {args.ref_ckpt}"
                  + (" (learned gamma)" if gamma is not None else ""))
        elif args.ckpt_dir:
            _load_ema(model, args.ckpt_dir,
                      shard=lambda sd: shard_state_dict(sd, dp, EGNN_TP_RULES))
        model.eval()

        np_rng = np.random.default_rng(cfg.seed)
        reps_path = os.path.join(args.data_dir, "reps.npy") if args.data_dir else None
        if reps_path and os.path.exists(reps_path):
            reps = np.load(reps_path).astype(np.float32)
            sizes = np.load(os.path.join(args.data_dir, "sizes.npy"))
            if reps.shape[1] != cfg.rep_nf:
                raise ValueError(f"{reps_path}: reps of width {reps.shape[1]}, the model "
                                 f"takes rep_nf {cfg.rep_nf}")
            print(f"GtSampler over {len(reps)} dataset reps from {args.data_dir}")
        else:
            if args.data_dir:
                print(f"WARNING: no reps.npy under {args.data_dir}; using random stand-in reps")
            reps = (np_rng.standard_normal((256, cfg.rep_nf)).astype(np.float32)
                    if cfg.rep_nf is not None else None)
            sizes = np_rng.integers(cfg.max_nodes // 2, cfg.max_nodes + 1, 256)
        sizes = np.minimum(sizes.astype(np.int64), cfg.max_nodes)
        rep_sampler = GtSampler(reps, sizes) if cfg.rep_nf is not None else None
        if args.rdm_ref_ckpt:
            # two-stage eval with a reference RDM as the rep sampler (reference:
            # eval_src/eval_analyze.py DDIMSampler path), whole on every rank
            rep_sampler = _rdm_rep_sampler(args.rdm_ref_ckpt, cfg, device)
            print(f"DDIM rep sampler from the reference RDM {args.rdm_ref_ckpt}")
        node_dist = DistributionNodes({int(s): float((sizes == s).sum())
                                       for s in np.unique(sizes)})

        clock = {"seconds": 0.0, "molecules": 0, "batches": 0}

        def mol_sampler(node_mask, edge_mask, rep, r):
            """This rank's rows of the replicate's molecules, timed (the global
            batch's molecules counted)."""
            synchronize(device)
            t0 = time.perf_counter()
            out = sample(cfg, model, node_mask, edge_mask, rep=rep, cfg_scale=cfg.edm.cfg_scale,
                         gamma=gamma, generator=torch.Generator(device=device).manual_seed(
                             cfg.seed + r))
            synchronize(device)
            clock["seconds"] += time.perf_counter() - t0
            clock["molecules"] += cfg.batch_size
            clock["batches"] += 1
            return out

        def sample_replicate(r):
            nodes = node_dist.sample(np_rng, cfg.batch_size)
            sampler = TwoStageSampler(rep_sampler,
                                      lambda nm, em, rep: mol_sampler(nm, em, rep, r), dp=dp)
            # reed_tpu's GtSampler draws from default_rng(seed + replicate)
            x, h_cat, _, node_mask = sampler.sample(np.random.default_rng(cfg.seed + r),
                                                    nodes, cfg.max_nodes, device=device)
            return molecules_from_samples(x, h_cat, node_mask)

        if main:
            out = evaluate_replicates(sample_replicate, MoleculeMetrics(),
                                      n_replicates=args.n_replicates)
        else:
            for r in range(args.n_replicates):
                sample_replicate(r)
        steps = (cfg.efm.ode_steps * (4 if cfg.efm.ode_method == "rk4" else 1)
                 if cfg.probabilistic_model == "fm" else cfg.edm.timesteps + 1)
        print(f"{clock['molecules'] / clock['seconds']:.3f} molecules/s, "
              f"{1e3 * clock['seconds'] / (clock['batches'] * steps):.3f} ms per network "
              f"evaluation ({clock['batches']} batches of {cfg.batch_size}, {steps} "
              f"evaluations a batch, {cfg.probabilistic_model}, {device}, {_ranks(dp)})")

        if args.out:
            # one replicate as xyz + 3D PNG renders (reference:
            # eval_src/{eval_visualize_samples,process_uncondition_random}.py)
            decoder = QM9_ATOM_DECODER if cfg.num_atom_types <= 5 else GEOM_ATOM_DECODER
            molecules = sample_replicate(0)[:100]
            if main:
                _write_molecules(args.out, molecules, decoder)
        if args.data_dir:
            # the MOSES block and the MiDi distances against the held-out test
            # split (reference: eval_src/evaluation/molsets.py get_all_metrics)
            from reed_tpu_torch.data.molecule import load_dataset
            from reed_tpu_torch.eval.midi_metrics import midi_sampling_metrics
            from reed_tpu_torch.eval.molsets import geometric_mols_from_samples, moses_metrics

            try:
                test_mols = load_dataset(_find_split(args.data_dir, "test"))
            except FileNotFoundError:
                test_mols = None
            if test_mols:
                molecules = sample_replicate(args.n_replicates)
                if main:
                    gen_mols = geometric_mols_from_samples(molecules, QM9_ATOM_DECODER)
                    out["moses"] = moses_metrics(gen_mols, test_mols,
                                                 vocab_tokens=QM9_ATOM_DECODER, device=device)
                    # the test split must use the sampler's atom-type index space
                    out["midi"] = midi_sampling_metrics(gen_mols, test_mols,
                                                        num_atom_types=len(QM9_ATOM_DECODER))
        if not main:
            return None
        print(json.dumps(out, indent=2))
    return out


def _write_molecules(out_dir: str, molecules, decoder, comments=None):
    """Each (positions, types) of `molecules` as mol_{i:03d}.xyz (with
    comments[i] on its comment line), and as mol_{i:03d}.png where matplotlib
    is installed; without it one line says that the PNGs were skipped."""
    from reed_tpu_torch.eval.visualize import (have_matplotlib, plot_molecule_3d,
                                               save_xyz_file)

    os.makedirs(out_dir, exist_ok=True)
    pngs = have_matplotlib()
    for i, (pos, types) in enumerate(molecules):
        comment = comments[i] if comments else ""
        save_xyz_file(os.path.join(out_dir, f"mol_{i:03d}.xyz"), pos, types,
                      atom_decoder=decoder, comment=comment)
        if pngs:
            plot_molecule_3d(os.path.join(out_dir, f"mol_{i:03d}.png"), pos, types,
                             atom_decoder=decoder, title=comment)
    kinds = ".xyz and .png" if pngs else ".xyz"
    print(f"sample dumps ({len(molecules)} {kinds}) -> {out_dir}")
    if not pngs:
        print("3D PNG renders skipped: matplotlib is not installed")


def train_property(args):
    """Train the EGNN property regressor (reference:
    qm9/property_prediction/main_qm9_prop.py) on synthetic batches or on the
    QM9 EDM npz train split under --data-dir with its --property column
    (mean and mad from that column), or with --linear-probe a linear head on
    the frozen-encoder reps.npy beside it (reference:
    main_qm9_prop_pretrainedEnc_linear.py); logging `[step N] {...}` every
    --log-every steps, then the rate of the steps after the first."""
    from reed_tpu_torch.train.property import (LinearProbeConfig, LinearProbeTrainer,
                                               PropertyTrainConfig, PropertyTrainer,
                                               batch_to_device, compute_mean_mad,
                                               property_epoch_batches)

    device = resolve_device(args.device)
    flags = {"batch_size": args.batch_size, "seed": args.seed,
             "optim": {"lr": args.lr} if args.lr is not None else None}
    defaults = {"property": args.property}
    data = None
    if args.data_dir and not args.synthetic:
        from reed_tpu_torch.data.molecule import load_qm9_edm_npz

        data = load_qm9_edm_npz(_find_split(args.data_dir, "train"))
        if args.property not in data:
            raise SystemExit(f"property '{args.property}' not in npz keys {sorted(data)}")
        mean, mad = compute_mean_mad(data[args.property])
        defaults.update(mean=mean, mad=mad)
        print(f"property {args.property}: mean={mean:.4f} mad={mad:.4f}")

    def check_one_batch(cfg):
        n = len(data["positions"])
        if n < cfg.batch_size:
            raise SystemExit(f"{n} molecules under {args.data_dir}, fewer than one batch "
                             f"of {cfg.batch_size}")

    def synthetic(trainer, seed):
        i = 0
        while True:
            yield trainer.synthetic_batch(torch.Generator(device=device).manual_seed(seed + i))
            i += 1

    if args.linear_probe:
        reps = None
        if data is not None:
            reps = np.load(os.path.join(args.data_dir, "reps.npy")).astype(np.float32)
            labels = np.asarray(data[args.property], np.float32)
            if len(reps) != len(labels):
                raise ValueError(f"reps.npy holds {len(reps)} reps for {len(labels)} "
                                 "molecules")
            defaults["rep_dim"] = reps.shape[1]
        cfg = _resolve_cfg(LinearProbeConfig, args, flags, defaults)
        if reps is not None:
            check_one_batch(cfg)
        trainer = LinearProbeTrainer(cfg, device=device)

        def probe_batches():
            epoch = 0
            while True:
                order = np.random.default_rng(cfg.seed + epoch).permutation(len(reps))
                for i in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
                    idx = order[i:i + cfg.batch_size]
                    yield batch_to_device(local_batch(
                        trainer.dp, {"rep": reps[idx], "label": labels[idx]}), device)
                epoch += 1

        batches = synthetic(trainer, cfg.seed) if reps is None else probe_batches()
        return _run_loop(trainer, trainer.init_state(), batches, args,
                         _global_rows(trainer, "label"), cfg,
                         f"train-property linear probe {cfg.property} ({device})", "reps")

    cfg = _resolve_cfg(PropertyTrainConfig, args, flags, defaults)
    if data is not None:
        check_one_batch(cfg)
    trainer = PropertyTrainer(cfg, device=device)

    def data_batches():
        epoch = 0
        while True:
            rng = np.random.default_rng(cfg.seed + epoch)
            for batch in property_epoch_batches(data, cfg.property, cfg.batch_size, rng,
                                                max_nodes=cfg.max_nodes,
                                                num_atom_types=cfg.num_atom_types):
                yield batch_to_device(local_batch(trainer.dp, batch), device)
            epoch += 1

    batches = synthetic(trainer, cfg.seed) if data is None else data_batches()
    return _run_loop(trainer, trainer.init_state(), batches, args,
                     _global_rows(trainer, "label"), cfg,
                     f"train-property {cfg.property} ({device})", "molecules")


def eval_conditional(args):
    """Conditional-generation MAE (reference:
    molecule/eval_src/eval_conditional_qm9.py): property-conditioned
    molecules from the EDM model (context_node_nf 1, T = --num-steps; the
    EMA of --ckpt-dir's latest checkpoint), their sizes and targets drawn
    from the train split under --data-dir (random stand-ins without it),
    each target given as (target - mean) / mad on every node, scored by the
    property classifier of --classifier-ckpt (rebuilt from its config.json,
    its EMA weights). --sweep takes one size and a linspace of targets.
    Prints molecules/s and ms per network evaluation, then reed_tpu's
    JSON; --out writes the first replicate as .xyz (the target in the
    comment) and 3D PNG renders, and property_values.log. Under
    --distributed the sizes and targets are drawn for the whole replicate
    on every rank, each batch index samples and scores its rows, the
    tensor ranks split the EDM and the classifier (EGNN_TP_RULES), as
    reed_tpu builds both on its mesh; rank 0 scores the gathered
    predictions and writes."""
    from reed_tpu_torch.data.molecule import QM9_ATOM_DECODER
    from reed_tpu_torch.eval.molecule_metrics import DistributionNodes, DistributionProperty
    from reed_tpu_torch.models.property_classifier import conditional_generation_mae
    from reed_tpu_torch.parallel.mesh import EGNN_TP_RULES, data_parallel, run_rows
    from reed_tpu_torch.train import property as property_train
    from reed_tpu_torch.train.molecule_edm import MoleculeEDMConfig, build_dynamics, sample

    device = resolve_device(args.device)
    np_rng = np.random.default_rng(args.seed or 0)
    gen_cfg = _resolve_cfg(MoleculeEDMConfig, args, {"seed": args.seed},
                           defaults={"batch_size": args.n_samples, "context_node_nf": 1,
                                     "edm": {"timesteps": args.num_steps}})
    dp = data_parallel(gen_cfg.mesh, axes=EGNN_AXES)
    main = dp is None or dp.is_main

    def shard(sd):
        return shard_state_dict(sd, dp, EGNN_TP_RULES)

    with _main_prints(dp):
        model = build_dynamics(gen_cfg, device=device, parallel=dp,
                               generator=torch.Generator(device=device).manual_seed(gen_cfg.seed))
        if args.ckpt_dir:
            _load_ema(model, args.ckpt_dir, shard=shard)
        model.eval()

        # property and size distributions from the train split where there is one
        if args.data_dir:
            from reed_tpu_torch.data.molecule import load_qm9_edm_npz

            data = load_qm9_edm_npz(_find_split(args.data_dir, "train"))
            sizes_src = np.minimum(np.asarray(data["num_atoms"], np.int64), gen_cfg.max_nodes)
            values = np.asarray(data[args.property], np.float64)
            mean, mad = property_train.compute_mean_mad(values)
        else:
            sizes_src = np_rng.integers(gen_cfg.max_nodes // 2, gen_cfg.max_nodes + 1, 512)
            values = np_rng.standard_normal(512)
            mean, mad = 0.0, 1.0
        node_dist = DistributionNodes({int(s): float((sizes_src == s).sum())
                                       for s in np.unique(sizes_src)})
        prop_dist = DistributionProperty(sizes_src, values)

        clf_cfg = property_train.PropertyTrainConfig(
            property=args.property, mean=mean, mad=mad, num_atom_types=gen_cfg.num_atom_types,
            max_nodes=gen_cfg.max_nodes, mesh=gen_cfg.mesh)
        if args.classifier_ckpt:
            # the widths and the normaliser come from the training run's own
            # config snapshot (written by train-property beside its checkpoints)
            snap_path = os.path.join(args.classifier_ckpt, "config.json")
            if os.path.exists(snap_path):
                snap = configlib.load_file(snap_path)
                snap["mesh"] = gen_cfg.mesh.__dict__
                clf_cfg = configlib.merge(clf_cfg, snap)
        # the classifier on the eval's mesh, split as the EDM is
        clf_model = property_train.build_model(
            clf_cfg, device=device, parallel=dp,
            generator=torch.Generator(device=device).manual_seed(clf_cfg.seed))
        if args.classifier_ckpt:
            _load_ema(clf_model, args.classifier_ckpt, shard=shard)
        clf_model.eval()

        n = gen_cfg.max_nodes
        clock = {"seconds": 0.0, "molecules": 0, "batches": 0}

        def sample_and_score(rows, seed):
            """This rank's rows: (x, h_cat, the classifier's predictions)."""
            node_mask, edge_mask, context, rep = rows
            synchronize(device)
            t0 = time.perf_counter()
            x, h_cat, _ = sample(gen_cfg, model, node_mask, edge_mask, rep=rep, context=context,
                                 generator=torch.Generator(device=device).manual_seed(seed))
            synchronize(device)
            clock["seconds"] += time.perf_counter() - t0
            return x, h_cat, property_train.predict(clf_cfg, clf_model, h_cat, x, node_mask,
                                                    edge_mask)

        maes, all_targets, sweep_rows = [], [], None
        for rep_i in range(args.n_replicates):
            if args.sweep:
                # one size, the property's linspace over the observed range
                # (reference: qm9/sampling.py:186 sample_sweep_conditional and
                # eval_src/process_sweep.py's classifier readback)
                sizes = np.full(args.n_samples, int(np.median(sizes_src)), np.int64)
                targets = np.linspace(float(values.min()), float(values.max()), args.n_samples)
            else:
                sizes = node_dist.sample(np_rng, args.n_samples)
                targets = prop_dist.sample(np_rng, sizes)         # label units
            norm_t = (targets - mean) / mad                       # context units
            node_mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)[..., None]
            diag = np.eye(n, dtype=np.float32)[None, :, :, None]
            edge_mask = node_mask[:, :, None, :] * node_mask[:, None, :, :] * (1 - diag)
            context = np.broadcast_to(norm_t[:, None, None].astype(np.float32),
                                      (args.n_samples, n, 1)) * node_mask
            rep = None
            if gen_cfg.rep_nf:
                rep = torch.from_numpy(np_rng.standard_normal(
                    (args.n_samples, gen_cfg.rep_nf)).astype(np.float32)).to(device)
            rows = tuple(torch.from_numpy(a).to(device) for a in (node_mask, edge_mask, context))
            x, h_cat, preds = run_rows(dp, args.n_samples, rows + (rep,),
                                       lambda r: sample_and_score(r, (args.seed or 0) + rep_i))
            clock["molecules"] += args.n_samples
            clock["batches"] += 1
            if not main:
                continue
            maes.append(conditional_generation_mae(lambda p: p, preds, targets))
            all_targets.append(targets)
            preds = preds.cpu().numpy()
            if args.sweep and sweep_rows is None:
                sweep_rows = [{"target": float(t), "pred": float(p)}
                              for t, p in zip(targets, preds)]
            if args.out and rep_i == 0:
                # the molecules, their targets and renders (reference:
                # eval_src/eval_visualize_samples.py, qm9/visualizer.py plot_data3d)
                types = torch.argmax(h_cat, dim=-1).cpu().numpy()
                xs, mask = x.cpu().numpy(), node_mask[..., 0].astype(bool)
                k = min(args.n_samples, 100)
                _write_molecules(args.out,
                                 [(xs[i][mask[i]], types[i][mask[i]]) for i in range(k)],
                                 QM9_ATOM_DECODER,
                                 comments=[f"{args.property}={targets[i]:.4f}"
                                           for i in range(k)])
                with open(os.path.join(args.out, "property_values.log"), "w") as f:
                    f.write("\n".join(f"{t:.6f}" for t in targets))
        steps = gen_cfg.edm.timesteps + 1
        print(f"{clock['molecules'] / clock['seconds']:.3f} molecules/s, "
              f"{1e3 * clock['seconds'] / (clock['batches'] * steps):.3f} ms per network "
              f"evaluation ({clock['batches']} batches of {args.n_samples}, {steps} "
              f"evaluations a batch, {device}, {_ranks(dp)})")
        if not main:
            return None
        targets_all = np.concatenate(all_targets)
        out = {"property": args.property, "mae": float(np.mean(maes)),
               "mae_std": float(np.std(maes)), "n_samples": args.n_samples * args.n_replicates,
               # the predict-the-mean floor, for context (the reference logs it too)
               "mad_of_targets": float(np.abs(targets_all - targets_all.mean()).mean())}
        if sweep_rows is not None:
            out["sweep"] = sweep_rows
            t = np.array([r["target"] for r in sweep_rows])
            p = np.array([r["pred"] for r in sweep_rows])
            if len(t) > 2 and t.std() > 0 and p.std() > 0:
                out["sweep_pearson_r"] = float(np.corrcoef(t, p)[0, 1])
        print(json.dumps(out, indent=2))
    return out


def train_rdm(args):
    """Train the RDM, the GeoRCG rep sampler, on synthetic batches
    (reed_tpu's: N(0, 1) reps, atom counts in [5, max_nodes)) or on the
    reps.npy and sizes.npy under --data-dir (shuffled each epoch), logging
    `[step N] {...}` every --log-every steps; then 3 reps sampled from the
    EMA by 10 DDIM steps, as reed_tpu's train-rdm ends."""
    from reed_tpu_torch.eval.rep_samplers import DDIMRepSampler
    from reed_tpu_torch.train.rdm import RDMTrainConfig, RDMTrainer, batch_to_device

    device = resolve_device(args.device)
    cfg = _resolve_cfg(RDMTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None})
    trainer = RDMTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield trainer.synthetic_batch(torch.Generator(device=device).manual_seed(i))
                i += 1
    else:
        # precomputed encoder reps and molecule sizes (reference:
        # molecule/src/rdm/main_rdm_sampling.py)
        reps = np.load(os.path.join(args.data_dir, "reps.npy"))
        sizes = np.load(os.path.join(args.data_dir, "sizes.npy"))
        if reps.shape[1] != cfg.channels:
            raise ValueError(f"reps.npy holds reps of width {reps.shape[1]}, the RDM takes "
                             f"channels {cfg.channels}")
        print(f"loaded {len(reps)} reps from {args.data_dir}")

        def batches():
            epoch = 0
            while True:
                order = np.random.default_rng(cfg.seed + epoch).permutation(len(reps))
                for i in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
                    idx = order[i:i + cfg.batch_size]
                    yield batch_to_device(local_batch(
                        trainer.dp, {"rep": reps[idx], "num_atoms": sizes[idx]}), device)
                epoch += 1

    state = _run_loop(trainer, state, batches(), args, _global_rows(trainer, "rep"), cfg,
                      f"train-rdm ({device})", "reps")
    ema_model = trainer.ema_model(state)  # every rank: the EMA may be gathered
    if trainer.dp is None or trainer.dp.is_main:
        sampler = DDIMRepSampler(trainer.diffusion(ema_model), eta=1.0,
                                 step_num=10)
        reps = sampler.sample(torch.Generator(device=device).manual_seed(0),
                              np.array([9, 12, 15]))
        print("sampled reps:", tuple(reps.shape), "finite:", bool(torch.isfinite(reps).all()))
    return state


def _multiflow_ref_ckpt(model, path, cfg, parallel=None):
    """Load a reference torch MultiFlow / Lightning checkpoint into `model`
    (a tensor rank's shards of it under `parallel`); its widths must be the
    configuration's (set them with --set)."""
    from reed_tpu_torch.encoders.multiflow_convert import load_reference_checkpoint
    from reed_tpu_torch.parallel.mesh import shard_state_dict
    from reed_tpu_torch.train.multiflow import tp_rules

    sd, widths = load_reference_checkpoint(path)
    wrong = {k: (v, getattr(cfg, k)) for k, v in widths.items() if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"{path}: widths (checkpoint, config) {wrong}; set them with --set")
    model.load_state_dict(shard_state_dict(sd, parallel, tp_rules(cfg)))


def train_multiflow(args):
    """Train MultiFlow SE(3) codesign on synthetic batches (reed_tpu's
    synthetic_batch schema, numpy seed i for batch i) or on the .pdb/.cif
    chains under --data-dir (shuffled epochs cropped or padded to
    max_len), with the batch-OT prior coupled on the host where the
    interpolant asks for it, logging `[step N] {...}` every --log-every
    steps, then the rate of the steps after the first in residues/s."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.train.multiflow import (MultiflowTrainConfig, MultiflowTrainer,
                                                batch_to_device)

    device = resolve_device(args.device)
    cfg = _resolve_cfg(MultiflowTrainConfig, args,
                       {"batch_size": args.batch_size, "seed": args.seed,
                        "optim": {"lr": args.lr} if args.lr is not None else None})
    trainer = MultiflowTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        with whole_params(state.opt.plan, write=True):
            _multiflow_ref_ckpt(state.model, args.ref_ckpt, cfg, trainer.dp)
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype, state.opt.plan)
        print(f"warm-started from reference checkpoint {args.ref_ckpt}")

    if args.synthetic or not args.data_dir:
        def batches():
            i = 0
            while True:
                yield trainer.synthetic_batch(np.random.default_rng(i))
                i += 1
    else:
        from reed_tpu_torch.data.protein import load_multiflow_entries, multiflow_epoch_batches

        entries = load_multiflow_entries(args.data_dir)
        if not entries:
            raise FileNotFoundError(f"no .pdb/.cif chains found in {args.data_dir}")
        print(f"loaded {len(entries)} chains from {args.data_dir}")

        def batches():
            epoch = 0
            while True:
                rng = np.random.default_rng(cfg.seed + epoch)
                for batch in multiflow_epoch_batches(
                        args.data_dir, cfg.batch_size, rng, max_len=cfg.max_len,
                        entries=entries, trans_batch_ot=cfg.interpolant.trans_batch_ot,
                        trans_scale=cfg.interpolant.trans_scale):
                    yield batch_to_device(local_batch(trainer.dp, batch), device)
                epoch += 1

    def residues(batch):
        n = batch["res_mask"].sum()
        return int((n if trainer.dp is None else trainer.dp.all_sum(n)).item())

    return _run_loop(trainer, state, batches(), args, residues, cfg,
                     f"train-multiflow {cfg.compute_dtype} ({device})", "residues")


def eval_multiflow(args):
    """Sample --num-samples backbones and sequences of --length residues
    from the latest checkpoint's EMA under --ckpt-dir (or a reference
    checkpoint, or the seeded initial weights) by --num-steps Euler steps,
    write them as PDB files under --out and report the backbone geometry
    (reference: multiflow/experiments/inference_se3_flows.py; folding
    designability needs an external folding tool, eval.protein_metrics.
    FoldingModel). Prints ms per sampler step, then reed_tpu's JSON. Under
    --distributed the samples split over the data x fsdp batch indices and
    the tensor ranks split the IPA trunk (tp_rules); rank 0 writes them."""
    from reed_tpu_torch.eval.protein_metrics import (backbone_geometry_report,
                                                     write_pdb_backbone)
    from reed_tpu_torch.ops.residue_constants import RESTYPES, to_atom37
    from reed_tpu_torch.parallel.mesh import data_parallel, run_rows
    from reed_tpu_torch.train.multiflow import MultiflowTrainConfig, build_model, sample, tp_rules

    device = resolve_device(args.device)
    cfg = _resolve_cfg(MultiflowTrainConfig, args, {"seed": args.seed})
    dp = data_parallel(cfg.mesh, axes=IPA_AXES)
    with _main_prints(dp):
        model = build_model(cfg, device=device, parallel=dp,
                            generator=torch.Generator(device=device).manual_seed(cfg.seed))
        if args.ref_ckpt:
            _multiflow_ref_ckpt(model, args.ref_ckpt, cfg, dp)
            print(f"loaded reference torch checkpoint {args.ref_ckpt}")
        elif args.ckpt_dir:
            _load_ema(model, args.ckpt_dir,
                      shard=lambda sd: shard_state_dict(sd, dp, tp_rules(cfg)))
        model.eval()

        def run(n, steps):
            """The global batch of n samples (this rank's rows sampled)."""
            return run_rows(dp, n, torch.ones((n, args.length), device=device),
                            lambda res_mask: sample(
                                cfg, model, res_mask, num_timesteps=steps,
                                generator=torch.Generator(device=device).manual_seed(cfg.seed)))

        steps = args.num_steps or cfg.interpolant.num_timesteps
        # one untimed 2-step sample first: the first calls set up the device's
        # libraries, which is not sampling time
        run(1, 2)
        synchronize(device)
        t0 = time.perf_counter()
        out = run(args.num_samples, steps)
        atom37 = to_atom37(out["trans"], out["rotmats"]).cpu().numpy()
        seconds = time.perf_counter() - t0
        aatypes = out["aatypes"].cpu().numpy()
        print(f"{1e3 * seconds / steps:.3f} ms per sampler step ({args.num_samples} x "
              f"{args.length} residues, {steps} model calls, after a 2-step warm-up, {device}, "
              f"{_ranks(dp)})")
        if dp is not None and not dp.is_main:
            return None
        reports = []
        out_dir = args.out or "out/multiflow_samples"
        for i in range(args.num_samples):
            rep = backbone_geometry_report(atom37[i])
            rep["pdb"] = write_pdb_backbone(os.path.join(out_dir, f"sample_{i}.pdb"),
                                            atom37[i], aatypes=aatypes[i])
            rep["sequence"] = "".join(RESTYPES[int(t)] if 0 <= int(t) < 20 else "X"
                                      for t in aatypes[i])
            reports.append(rep)
        mean = {k: float(np.mean([r[k] for r in reports]))
                for k in ("ca_ca_dist_mean", "radius_of_gyration", "ca_clash_fraction")}
        result = {"mean": mean, "samples": reports}
        print(json.dumps(result, indent=2))
    return result


def _add_config(p, what):
    p.add_argument("--config", default=None,
                   help=f"JSON {what} tree (full or partial), e.g. a file of recipes/")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help=f"dotted-path {what} override, e.g. optim.lr=3e-4 or "
                        "curriculum.diffusion_warmup_steps=0")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")


def _add_mesh(p, axes, splits: str):
    """reed_tpu's mesh flags and --distributed (every subcommand but
    compute-fid runs over the ranks torchrun launches; --batch-size,
    --n-samples and --num-samples are global); `axes` the model axes its
    family runs (parallel.mesh.SIT_AXES, PMPNN_AXES, SEMLA_AXES, EGNN_AXES,
    IPA_AXES, RDM_AXES), `splits` what its tensor ranks split."""
    from reed_tpu_torch.parallel.mesh import SEQ_AXIS

    ranks = "data x fsdp x seq x tensor"
    for flag, axis in (("--dp", "data: the ranks that hold one copy of the optimizer state "
                                f"and EMA, and split the batch; {ranks} ranks run"),
                       ("--fsdp", "fsdp: ranks that shard the parameters, optimizer state "
                                  f"and EMA (and split the batch); {ranks} ranks run"),
                       ("--tp", f"tensor: ranks that split {splits}"),
                       ("--sp", "seq: ranks that split SiT's tokens" if SEQ_AXIS in axes
                        else "seq: only 1 (the seq axis splits SiT's tokens alone)")):
        p.add_argument(flag, type=int, default=None, help=f"mesh axis size ({axis})")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes (NCCL with one card a "
                        "rank; gloo with --device cpu); the batch is global")
    p.set_defaults(model_axes=tuple(axes))


def _add_training(p):
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic batches (the default without --data-dir)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoints, config.json and metrics.jsonl; with --ckpt-every "
                        "the run resumes from its latest checkpoint")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save a checkpoint every N steps (0: none)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps 3-8 (from 1) here")


def main(argv=None):
    parser = argparse.ArgumentParser("reed_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("generate-image")
    p.add_argument("--model", default=None, help="e.g. SiT-XL/2 (default SiT-B/2)")
    p.add_argument("--num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mode", default="sde", choices=["sde", "ode"])
    p.add_argument("--num-steps", type=int, default=50)
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--guidance-low", type=float, default=0.0)
    p.add_argument("--guidance-high", type=float, default=1.0)
    p.add_argument("--vae", default=None,
                   help="SD-VAE decoder npz (tools/convert_vae.py); required for the "
                        "ADM suite's uint8 pixel npz")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch .pt checkpoint (forces exact_gelu "
                        "for parity)")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this run's latest checkpoint")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype (default: the config's bfloat16)")
    _add_config(p, "ImageTrainConfig")
    _add_mesh(p, axes=SIT_AXES, splits="SiT's heads and MLP")
    p.set_defaults(fn=generate_image)

    p = sub.add_parser("compute-fid")
    p.add_argument("ref", help="reference stats npz ({mu,sigma}) or image npz")
    p.add_argument("gen", help="generated stats npz or image npz")
    p.add_argument("--inception-npz", default=None,
                   help="InceptionV3 pool3 weights npz (reed_tpu's save_variables_npz "
                        "layout); needed for image npz inputs")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--save-stats", action="store_true",
                   help="save computed stats next to each image npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    p.set_defaults(fn=compute_fid)

    p = sub.add_parser("eval-protein")
    p.add_argument("--num-steps", type=int, default=100)
    p.add_argument("--length", type=int, default=64)
    p.add_argument("--max-chains", type=int, default=None,
                   help="cap on valid-split chains to score")
    p.add_argument("--batch-size", type=int, default=None, help="default 4")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch fmif checkpoint (epoch_last.pt); "
                        "model flags must match via --set")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this run's latest checkpoint")
    p.add_argument("--data-dir", default=None,
                   help="PDB dataset (list.csv, split files, pdb/); scores "
                        "the valid split")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (default: the config's float32)")
    p.add_argument("--fused-messages", default=None, choices=["auto", "on", "off"],
                   help="message chains through the fused kernels (auto, the "
                        "config's default: where they take the widths, else unfused)")
    _add_config(p, "ProteinTrainConfig")
    _add_mesh(p, axes=PMPNN_AXES,
              splits="ProteinMPNN's message chains (W2/W3 by their hidden width) and MLPs")
    p.set_defaults(fn=eval_protein)

    p = sub.add_parser("train-protein")
    p.add_argument("--batch-size", type=int, default=None,
                   help="synthetic batch size (default: the config's 8)")
    p.add_argument("--data-dir", default=None,
                   help="PDB dataset (list.csv, split files, pdb/, optional "
                        "repr/); trains on the train split")
    p.add_argument("--token-budget", type=int, default=20_000,
                   help="tokens per real-data batch (reference batch_size=20000)")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm start from a reference torch fmif checkpoint")
    _add_training(p)
    _add_config(p, "ProteinTrainConfig")
    _add_mesh(p, axes=PMPNN_AXES,
              splits="ProteinMPNN's message chains (W2/W3 by their hidden width) and MLPs")
    p.set_defaults(fn=train_protein)

    p = sub.add_parser("train-image")
    p.add_argument("--model", default=None, help="e.g. SiT-XL/2 (default SiT-B/2)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 256")
    p.add_argument("--data-dir", default=None,
                   help="cached latents: dataset.json and vae-sd/*.npy moments "
                        "(and pixels/ crops for --enc-type)")
    p.add_argument("--enc-type", default=None,
                   help="in-loop frozen encoders, e.g. dinov2-vit-b (needs "
                        "--encoder-dir weights and --data-dir pixel crops)")
    p.add_argument("--encoder-dir", default=None,
                   help="dir of encoder npz weights ({name}.npz; default "
                        "$REED_TPU_ENCODER_DIR)")
    p.add_argument("--pixels-subdir", default="pixels",
                   help="dataset subdir of raw uint8 crops")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm start from a reference torch SiT checkpoint "
                        "(forces exact_gelu)")
    p.add_argument("--sample-every", type=int, default=0,
                   help="preview grid of 16 EMA samples every N steps")
    p.add_argument("--vae", default=None,
                   help="SD-VAE decoder npz for the previews (else latent channels)")
    _add_training(p)
    _add_config(p, "ImageTrainConfig")
    _add_mesh(p, axes=SIT_AXES, splits="SiT's heads and MLP")
    p.set_defaults(fn=train_image)

    p = sub.add_parser("train-molecule-semla")
    p.add_argument("--batch-size", type=int, default=None,
                   help="synthetic batch size (default: the config's 64)")
    p.add_argument("--data-dir", default=None,
                   help="train.rsmol[.npz] split (and reps.npy beside it); "
                        "trains on it")
    p.add_argument("--batch-cost", type=int, default=4096,
                   help="padded atoms a real-data batch (reference batch_cost)")
    p.add_argument("--dataset", default="qm9", choices=["qm9", "geom"],
                   help="selects the coordinate normalisation std")
    p.add_argument("--coord-std", type=float, default=None,
                   help="explicit coordinate std (overrides --dataset)")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm start from a reference torch SemlaFlow/Lightning "
                        "checkpoint (dims via --set)")
    _add_training(p)
    _add_config(p, "SemlaTrainConfig")
    _add_mesh(p, axes=SEMLA_AXES,
              splits="SemlaFlow's message MLPs, attention heads and feed-forwards (arch "
                     "semla; the egnn and eqgat archs run whole on every tensor rank)")
    p.set_defaults(fn=train_molecule_semla)

    p = sub.add_parser("eval-semla")
    p.add_argument("--n-samples", type=int, default=64)
    p.add_argument("--n-replicates", type=int, default=3)
    p.add_argument("--num-steps", type=int, default=100)
    p.add_argument("--n-atoms-min", type=int, default=8)
    p.add_argument("--n-atoms-max", type=int, default=24)
    p.add_argument("--batch-size", type=int, default=None, help="default 16")
    p.add_argument("--sampling-strategy", default="linear", choices=["linear", "log"])
    # the semla vocab is GEOM-scale (P/S/Br/...); the qm9 bond tables only
    # cover H/C/N/O/F pairs, so the geom predictor is the default
    p.add_argument("--dataset", default="geom", choices=["qm9", "geom"])
    p.add_argument("--coord-std", type=float, default=None,
                   help="unscale generated coords by the dataset coord std")
    p.add_argument("--atom-decoder", default=None,
                   help="comma-separated element symbols per vocab index "
                        "(default: the semla vocab)")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch SemlaFlow/Lightning checkpoint (dims via --set)")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this run's latest checkpoint")
    p.add_argument("--out", default=None,
                   help="write replicate 0 as .xyz and predicted-bond .sdf files here")
    p.add_argument("--seed", type=int, default=None)
    _add_config(p, "SemlaTrainConfig")
    _add_mesh(p, axes=SEMLA_AXES,
              splits="SemlaFlow's message MLPs, attention heads and feed-forwards (arch "
                     "semla; the egnn and eqgat archs run whole on every tensor rank)")
    p.set_defaults(fn=eval_semla)

    p = sub.add_parser("train-molecule-edm")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 64")
    p.add_argument("--data-dir", default=None,
                   help="QM9 EDM npz train split (train.npz, and reps.npy beside it); "
                        "trains on it")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm start from a reference torch EDM checkpoint "
                        "(generative_model[_ema].npy; widths via --set)")
    _add_training(p)
    _add_config(p, "MoleculeEDMConfig")
    _add_mesh(p, axes=EGNN_AXES,
              splits="the EGNN's edge, node, coordinate and rep feed-forward MLPs")
    p.set_defaults(fn=train_molecule_edm)

    p = sub.add_parser("train-rdm")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 128")
    p.add_argument("--data-dir", default=None,
                   help="reps.npy [N, channels] and sizes.npy [N]; trains on them")
    _add_training(p)
    _add_config(p, "RDMTrainConfig")
    _add_mesh(p, axes=RDM_AXES,
              splits="the RDM's residual blocks (in_fc, emb_fc, context_fc and out_fc, "
                     "with out_norm over the split width)")
    p.set_defaults(fn=train_rdm)

    p = sub.add_parser("eval-molecule")
    p.add_argument("--n-replicates", type=int, default=3)
    p.add_argument("--num-steps", type=int, default=100,
                   help="the EDM sampler's T (sets edm.timesteps)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="molecules a replicate (default 16)")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch EDM checkpoint (generative_model[_ema].npy; "
                        "widths via --set)")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this run's latest checkpoint")
    p.add_argument("--rdm-ref-ckpt", default=None,
                   help="reference RDM checkpoint (LatentDiffusion .ckpt/.pt); its DDIM "
                        "sampler draws the reps instead of the GtSampler")
    p.add_argument("--data-dir", default=None,
                   help="reps.npy and sizes.npy for the GtSampler (random stand-in "
                        "reps without them); a test split (test.rsmol[.npz]) adds the "
                        "MOSES metrics and the MiDi distances")
    p.add_argument("--out", default=None,
                   help="write one replicate as .xyz files here, and 3D PNG renders where "
                        "matplotlib is installed")
    p.add_argument("--seed", type=int, default=None)
    _add_config(p, "MoleculeEDMConfig")
    _add_mesh(p, axes=EGNN_AXES,
              splits="the EGNN's edge, node, coordinate and rep feed-forward MLPs (the "
                     "rep sampler runs whole on every rank)")
    p.set_defaults(fn=eval_molecule)

    p = sub.add_parser("train-property")
    p.add_argument("--property", default="alpha",
                   help="QM9 property column: alpha|gap|homo|lumo|mu|Cv|...")
    p.add_argument("--linear-probe", action="store_true",
                   help="a linear head on frozen-encoder reps (reps.npy) instead of the "
                        "EGNN regressor")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 96")
    p.add_argument("--data-dir", default=None,
                   help="QM9 EDM npz train split with the property column (and reps.npy "
                        "beside it for --linear-probe); trains on it, mean and mad from it")
    _add_training(p)
    _add_config(p, "PropertyTrainConfig (LinearProbeConfig with --linear-probe)")
    _add_mesh(p, axes=EGNN_AXES,
              splits="the classifier's edge and node MLPs (--linear-probe runs whole on "
                     "every tensor rank)")
    p.set_defaults(fn=train_property)

    p = sub.add_parser("eval-conditional")
    p.add_argument("--property", default="alpha")
    p.add_argument("--n-samples", type=int, default=16)
    p.add_argument("--n-replicates", type=int, default=2)
    p.add_argument("--num-steps", type=int, default=50,
                   help="the EDM sampler's T: the model is built with edm.timesteps set "
                        "to it, as reed_tpu builds it, not the trained model's")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this train-molecule-edm run's "
                        "latest checkpoint (trained with --set context_node_nf=1)")
    p.add_argument("--classifier-ckpt", default=None,
                   help="train-property checkpoint dir (its config.json and EMA weights)")
    p.add_argument("--data-dir", default=None,
                   help="QM9 EDM npz train split with the property column: the size and "
                        "target distributions, mean and mad")
    p.add_argument("--sweep", action="store_true",
                   help="fixed-size property-linspace sweep (reference "
                        "sample_sweep_conditional + process_sweep)")
    p.add_argument("--out", default=None,
                   help="xyz + property_values.log output dir, and 3D PNG renders where "
                        "matplotlib is installed (reference eval_visualize_samples.py)")
    p.add_argument("--seed", type=int, default=None)
    _add_config(p, "MoleculeEDMConfig")
    _add_mesh(p, axes=EGNN_AXES,
              splits="the EDM's and the property classifier's EGNN MLPs")
    p.set_defaults(fn=eval_conditional)

    p = sub.add_parser("train-multiflow")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 4")
    p.add_argument("--data-dir", default=None,
                   help="a directory of .pdb/.cif chains; trains on them")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm-start from a reference torch MultiFlow / Lightning checkpoint "
                        "(widths via --set)")
    _add_training(p)
    _add_config(p, "MultiflowTrainConfig")
    _add_mesh(p, axes=IPA_AXES,
              splits="the IPA heads and the sequence transformer's heads and feed-forward")
    p.set_defaults(fn=train_multiflow)

    p = sub.add_parser("eval-multiflow")
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--length", type=int, default=64)
    p.add_argument("--num-steps", type=int, default=100)
    p.add_argument("--out", default=None, help="PDB output directory")
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch MultiFlow / Lightning checkpoint (widths via --set)")
    p.add_argument("--ckpt-dir", default=None,
                   help="sample from the EMA weights of this run's latest checkpoint")
    p.add_argument("--seed", type=int, default=None)
    _add_config(p, "MultiflowTrainConfig")
    _add_mesh(p, axes=IPA_AXES,
              splits="the IPA heads and the sequence transformer's heads and feed-forward")
    p.set_defaults(fn=eval_multiflow)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
