"""Command line of the PyTorch/CUDA port.

  python -m reed_tpu_torch.cli generate-image --model SiT-XL/2 \\
      --num-samples 64 --batch-size 32 --num-steps 250 --cfg-scale 1.8 \\
      --guidance-high 0.7 --ref-ckpt sit_xl.pt --out out/samples.npz
  python -m reed_tpu_torch.cli eval-protein --batch-size 8 --length 256 \\
      --num-steps 50 [--data-dir pdb_2021aug02] [--ref-ckpt epoch_last.pt]
  python -m reed_tpu_torch.cli train-protein --steps 100 --synthetic \\
      [--data-dir pdb_2021aug02 --token-budget 20000] [--set optim.lr=3e-4]
  python -m reed_tpu_torch.cli train-image --model SiT-XL/2 --batch-size 48 \\
      --steps 100 --synthetic [--data-dir latents/] [--set optim.mu_dtype=bfloat16]

Runs on CUDA unless `--device cpu` is given. generate-image uses reed_tpu's
image default (ImageTrainConfig / build_model in reed_tpu/train/image.py):
32x32x4 latents, 1000 classes, bf16 compute. eval-protein and train-protein
use its protein default (ProteinTrainConfig): ProteinMPNN-FMIF, hidden 128,
3 + 3 layers, 30 neighbours, f32 compute; training adds dropout 0.1, the AF3
alignment loss and Adam with a global-norm clip. train-image uses its
image default (ImageTrainConfig): SiT-B/2, batch 256, bf16 compute with f32
master weights, one DINOv2-width projector at depth 8, Adam lr 1e-4.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from reed_tpu_torch import resolve_device


def generate_image(args):
    """Sample latents into an ADM-suite npz (arr_0)."""
    from reed_tpu_torch.encoders.sit_convert import load_reference_checkpoint
    from reed_tpu_torch.eval.fid import (FIDGenConfig, generate_samples,
                                         strip_projector_params)
    from reed_tpu_torch.models.sit import create_sit

    device = resolve_device(args.device)
    # torch-parity inference from a reference checkpoint needs erf GELU
    model = create_sit(args.model, device=device,
                       exact_gelu=bool(args.ref_ckpt))
    if args.ref_ckpt:
        sd = strip_projector_params(load_reference_checkpoint(args.ref_ckpt))
        missing, unexpected = model.load_state_dict(sd, strict=False)
        missing = [k for k in missing if not k.startswith("projectors.")]
        if missing or unexpected:
            raise ValueError(f"checkpoint {args.ref_ckpt} does not fit "
                             f"{args.model}: missing {missing}, "
                             f"unexpected {unexpected}")
        print(f"loaded reference checkpoint {args.ref_ckpt} (exact_gelu=True)")
    else:
        model.initialize_weights(torch.Generator(device=device).manual_seed(args.seed))
    model = model.to(getattr(torch, args.dtype)).eval()

    def model_fn(x, t, y):
        return model(x, t, y)[0]

    print("no VAE decoder in the port yet: the npz holds raw latents, not "
          "the 256x256 uint8 pixels the ADM FID suite expects")
    cfg = FIDGenConfig(num_samples=args.num_samples,
                       batch_size=args.batch_size or 64,
                       num_classes=model.y_embedder.num_classes,
                       latent_size=model.input_size,
                       latent_channels=model.in_channels,
                       mode=args.mode, num_steps=args.num_steps,
                       cfg_scale=args.cfg_scale,
                       guidance_low=args.guidance_low,
                       guidance_high=args.guidance_high, seed=args.seed)
    generate_samples(model_fn, cfg, device=device, out_npz=args.out)


def _apply_overrides(cfg, overrides):
    """KEY=VALUE overrides of a frozen dataclass config; KEY may be dotted
    into a nested dataclass (interpolant.temp=0.2); VALUE is read as JSON,
    else kept as a string."""
    for item in overrides:
        key, _, text = item.partition("=")
        try:
            value = json.loads(text)
        except json.JSONDecodeError:
            value = text
        *path, name = key.split(".")
        nodes = [cfg]
        for part in path:
            nodes.append(getattr(nodes[-1], part))
        if not hasattr(nodes[-1], name):
            raise ValueError(f"--set {item}: no field {key!r}")
        value = dataclasses.replace(nodes[-1], **{name: value})
        for node, part in zip(reversed(nodes[:-1]), reversed(path)):
            value = dataclasses.replace(node, **{part: value})
        cfg = value
    return cfg


def eval_protein(args):
    """Inverse-folding eval: Euler-unmask sampling conditioned on backbones
    and sequence recovery against the native sequence, on a synthetic batch
    or on the valid split under --data-dir."""
    from reed_tpu_torch.eval.protein_metrics import (sequence_recovery,
                                                     tokens_to_sequence)
    from reed_tpu_torch.train.protein import (ProteinTrainConfig, build_model,
                                              sample, synthetic_protein_batch)

    device = resolve_device(args.device)
    cfg = ProteinTrainConfig(batch_size=args.batch_size, seed=args.seed,
                             compute_dtype=args.dtype,
                             fused_messages=args.fused_messages)
    cfg = _apply_overrides(cfg, args.overrides)
    cfg = dataclasses.replace(cfg, interpolant=dataclasses.replace(
        cfg.interpolant, num_timesteps=args.num_steps))
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(cfg.seed))
    if args.ref_ckpt:
        from reed_tpu_torch.encoders.fmif_convert import load_reference_checkpoint

        # model flags must match the checkpoint (--set)
        model.load_state_dict(load_reference_checkpoint(args.ref_ckpt))
        print(f"loaded reference checkpoint {args.ref_ckpt}")

    def run(batch):
        """(pred, tokens) of one batch, with its seconds to the last token."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        pred, tokens = sample(
            model, batch, torch.Generator(device=device).manual_seed(cfg.seed + 1),
            cfg.interpolant)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return pred.cpu().numpy(), tokens.cpu().numpy(), time.perf_counter() - t0

    def report_speed(n_seqs, n_batches, seconds):
        steps = n_batches * (cfg.interpolant.num_timesteps - 1)
        print(f"{n_seqs / seconds:.3f} sequences/s, {1e3 * seconds / max(steps, 1):.3f} "
              f"ms per decoder step (encoder once per batch included; "
              f"{n_batches} batches, {device}, {cfg.compute_dtype}, "
              f"fused={model.fused})")

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
        print(json.dumps({
            "split": "valid",
            "num_chains": len(entries),
            "sequence_recovery": float(np.average(recs, weights=weights)),
            "sample_0": sample_seq[:80],
        }, indent=2))
        return

    batch = synthetic_protein_batch(
        torch.Generator(device=device).manual_seed(cfg.seed), cfg.batch_size,
        args.length)
    pred, tokens, seconds = run(batch)
    report_speed(len(pred), 1, seconds)
    mask = (batch["mask"] * batch["chain_M"]).cpu().numpy()
    print(json.dumps({
        "split": "synthetic",
        "sequence_recovery": sequence_recovery(pred, batch["S"].cpu().numpy(), mask),
        "sample_0": tokens_to_sequence(tokens[0], batch["mask"][0].cpu().numpy())[:80],
    }, indent=2))


def train_protein(args):
    """Train ProteinMPNN-FMIF on synthetic batches (batch_size x max_len,
    with AF3-style embeddings) or on the train split under --data-dir,
    logging `[step N] {...}` every --log-every steps."""
    from reed_tpu_torch.core.ema import ema_init
    from reed_tpu_torch.core.logging import MetricLogger
    from reed_tpu_torch.train.protein import ProteinTrainConfig, ProteinTrainer

    device = resolve_device(args.device)
    cfg = ProteinTrainConfig()
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=args.lr))
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    cfg = _apply_overrides(cfg, args.overrides)
    trainer = ProteinTrainer(cfg, device=device)
    state = trainer.init_state()
    if args.ref_ckpt:
        from reed_tpu_torch.encoders.fmif_convert import load_reference_checkpoint

        # warm start from a reference fmif checkpoint (train_fmif.py:225-237)
        state.model.load_state_dict(load_reference_checkpoint(args.ref_ckpt))
        state.ema = ema_init(state.model, cfg.curriculum.ema_dtype)
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
                    yield {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
                epoch += 1

    logger = MetricLogger()
    it = batches()
    for i in range(args.steps):
        batch = next(it)
        state, metrics = trainer.train_step(state, batch)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            logger.log(metrics, state.step, samples_per_step=int(batch["S"].shape[0]))
    return state


def train_image(args):
    """Train SiT with REED alignment on synthetic batches (N(0, 1) latents
    and encoder targets) or on the cached latents under --data-dir, logging
    `[step N] {...}` every --log-every steps, then the rate of the steps
    after the first (steps/s and imgs/s)."""
    from reed_tpu_torch.core.logging import MetricLogger
    from reed_tpu_torch.train.image import ImageTrainConfig, ImageTrainer

    unported = {"--sample-every": args.sample_every, "--vae": args.vae,
                "--enc-type": args.enc_type, "--ref-ckpt": args.ref_ckpt,
                "--ckpt-dir": args.ckpt_dir}
    given = [flag for flag, value in unported.items() if value]
    if given:
        raise NotImplementedError(
            f"train-image {', '.join(given)}: not ported (the port has no "
            "preview sampling, SD-VAE, frozen encoders, reference warm start or "
            "checkpoints yet)")
    device = resolve_device(args.device)
    cfg = ImageTrainConfig()
    # the mesh flags as reed_tpu reads them; the trainer refuses more than one device
    mesh = {k: v for k, v in (("data", args.dp), ("fsdp", args.fsdp),
                              ("tensor", args.tp), ("seq", args.sp)) if v is not None}
    for name, value in (("model", args.model), ("batch_size", args.batch_size),
                        ("seed", args.seed),
                        ("mesh", dataclasses.replace(cfg.mesh, **mesh) if mesh else None)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{name: value})
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, lr=args.lr))
    cfg = _apply_overrides(cfg, args.overrides)
    trainer = ImageTrainer(cfg, device=device)
    state = trainer.init_state()

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

        # as reed_tpu's train-image: no feature subdirectories, so zs is
        # empty and proj_loss is 0
        ds = CachedLatentDataset(ImageDatasetConfig(args.data_dir))
        if len(ds) < cfg.batch_size:
            raise SystemExit(f"{len(ds)} samples under {args.data_dir}, fewer "
                             f"than one batch of {cfg.batch_size}")

        def batches():
            epoch = 0
            while True:
                yield from epoch_batches(ds, cfg.batch_size, cfg.seed + epoch)
                epoch += 1

    logger = MetricLogger()
    it = batches()
    t0 = None
    for i in range(args.steps):
        batch = next(it)
        state, metrics = trainer.train_step(state, batch)
        if i == 0:
            _sync(device)
            t0 = time.perf_counter()
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            logger.log(metrics, state.step, samples_per_step=cfg.batch_size)
    _sync(device)
    if args.steps > 1:
        seconds = time.perf_counter() - t0
        n = args.steps - 1
        print(f"train-image: {n} steps after the first in {seconds:.3f} s: "
              f"{n / seconds:.3f} steps/s, {n * cfg.batch_size / seconds:.2f} imgs/s "
              f"({cfg.model}, batch {cfg.batch_size}, {cfg.compute_dtype}, {device})")
    return state


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser("reed_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("generate-image")
    p.add_argument("--model", default="SiT-B/2", help="e.g. SiT-XL/2")
    p.add_argument("--num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mode", default="sde", choices=["sde", "ode"])
    p.add_argument("--num-steps", type=int, default=50)
    p.add_argument("--cfg-scale", type=float, default=1.0)
    p.add_argument("--guidance-low", type=float, default=0.0)
    p.add_argument("--guidance-high", type=float, default=1.0)
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch .pt checkpoint (forces exact_gelu "
                        "for parity)")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.set_defaults(fn=generate_image)

    p = sub.add_parser("eval-protein")
    p.add_argument("--num-steps", type=int, default=100)
    p.add_argument("--length", type=int, default=64)
    p.add_argument("--max-chains", type=int, default=None,
                   help="cap on valid-split chains to score")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--ref-ckpt", default=None,
                   help="reference torch fmif checkpoint (epoch_last.pt); "
                        "model flags must match via --set")
    p.add_argument("--data-dir", default=None,
                   help="PDB dataset (list.csv, split files, pdb/); scores "
                        "the valid split")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fused-messages", default="auto", choices=["auto", "on", "off"],
                   help="message chains through the fused kernels (auto: where "
                        "they take the widths, else unfused)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="ProteinTrainConfig override, e.g. hidden_dim=64")
    p.set_defaults(fn=eval_protein)

    p = sub.add_parser("train-protein")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="synthetic batch size (default: the config's 8)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic batches (the default without --data-dir)")
    p.add_argument("--data-dir", default=None,
                   help="PDB dataset (list.csv, split files, pdb/, optional "
                        "repr/); trains on the train split")
    p.add_argument("--token-budget", type=int, default=20_000,
                   help="tokens per real-data batch (reference batch_size=20000)")
    p.add_argument("--ref-ckpt", default=None,
                   help="warm start from a reference torch fmif checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="ProteinTrainConfig override, e.g. optim.lr=3e-4 or "
                        "curriculum.diffusion_warmup_steps=0")
    p.set_defaults(fn=train_protein)

    p = sub.add_parser("train-image")
    p.add_argument("--model", default=None, help="e.g. SiT-XL/2 (default SiT-B/2)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the config's 256")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic batches (the default without --data-dir)")
    p.add_argument("--data-dir", default=None,
                   help="cached latents: dataset.json and vae-sd/*.npy moments")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="ImageTrainConfig override, e.g. optim.mu_dtype=bfloat16 or "
                        "curriculum.diffusion_warmup_steps=0")
    for flag in ("--dp", "--fsdp", "--tp", "--sp"):
        p.add_argument(flag, type=int, default=None,
                       help="mesh axis size; the port trains on one device, so only 1")
    # reed_tpu's flags that the port does not have yet: each raises
    p.add_argument("--sample-every", type=int, default=None, help="not ported")
    for flag in ("--vae", "--enc-type", "--ref-ckpt", "--ckpt-dir"):
        p.add_argument(flag, default=None, help="not ported")
    p.set_defaults(fn=train_image)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
