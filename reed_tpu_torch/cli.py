"""Command line of the PyTorch/CUDA port.

  python -m reed_tpu_torch.cli generate-image --model SiT-XL/2 \\
      --num-samples 64 --batch-size 32 --num-steps 250 --cfg-scale 1.8 \\
      --guidance-high 0.7 --ref-ckpt sit_xl.pt --out out/samples.npz

Runs on CUDA unless `--device cpu` is given. The model configuration is
reed_tpu's image default (ImageTrainConfig / build_model in
reed_tpu/train/image.py): 32x32x4 latents, 1000 classes, bf16 compute.
"""

from __future__ import annotations

import argparse

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

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
