"""Image dataset preprocessing, counterpart of reed_tpu/data/preprocessing.py:
raw ImageNet -> center-cropped 256 x 256 folder with a dataset.json, and
pixels -> SD-VAE latent moments through the port's VAEEncoder on the
device, as `.npy` files [8, H/8, W/8] in the layout data/image.py reads.

  python -m reed_tpu_torch.data.preprocessing convert --src <imagenet> --dst <dir>
  python -m reed_tpu_torch.data.preprocessing encode --src <dir> --dst <dir> \\
      --vae-npz <sd-vae encoder npz> [--device cuda]

The encoder npz is reed_tpu's layout: convert_diffusers_vae(part='encoder')
written flat with `params/...` keys.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from reed_tpu_torch import resolve_device


def center_crop_dhariwal(img, resolution: int = 256) -> np.ndarray:
    """ADM-style center crop of a PIL image: BOX-halve while at least twice
    the target, bicubic to the target's short side, crop the center
    square; uint8 [resolution, resolution, 3]."""
    from PIL import Image

    while min(*img.size) >= 2 * resolution:
        img = img.resize((img.size[0] // 2, img.size[1] // 2), Image.BOX)
    scale = resolution / min(*img.size)
    img = img.resize((round(img.size[0] * scale), round(img.size[1] * scale)),
                     Image.BICUBIC)
    arr = np.asarray(img.convert("RGB"))
    h, w = arr.shape[:2]
    top, left = (h - resolution) // 2, (w - resolution) // 2
    return arr[top:top + resolution, left:left + resolution]


def convert(src: str, dst: str, resolution: int = 256, limit: Optional[int] = None):
    """Class-subfolder ImageNet layout -> `images/` pngs + dataset.json labels."""
    from PIL import Image

    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    classes = sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))
    labels = []
    for label, cls in enumerate(classes):
        for fn in sorted(os.listdir(os.path.join(src, cls))):
            if limit is not None and len(labels) >= limit:
                break
            path = os.path.join(src, cls, fn)
            try:
                arr = center_crop_dhariwal(Image.open(path), resolution)
            except Exception as e:  # an unreadable file is skipped, as reed_tpu does
                print(f"skip {path}: {e}")
                continue
            out_name = f"img{len(labels):08d}.png"
            Image.fromarray(arr).save(os.path.join(dst, "images", out_name))
            labels.append([out_name, label])
    with open(os.path.join(dst, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    print(f"wrote {len(labels)} images -> {dst}")


@torch.no_grad()
def encode(src: str, dst: str, vae_npz: Optional[str] = None, batch_size: int = 16,
           device=None):
    """images/ pngs -> vae-sd/ moment `.npy`s [8, H/8, W/8] through the
    SD-VAE encoder on `device` (default cuda)."""
    from PIL import Image

    from reed_tpu_torch.encoders.vae import load_npz

    if vae_npz is None or not os.path.exists(vae_npz):
        raise FileNotFoundError(
            "SD-VAE encoder weights (npz) required; convert once with "
            "reed_tpu.encoders.vae.convert_diffusers_vae(part='encoder')")
    device = resolve_device(device)
    encoder = load_npz(vae_npz, part="encoder").to(device).eval()
    with open(os.path.join(src, "dataset.json")) as f:
        labels = json.load(f)["labels"]
    os.makedirs(os.path.join(dst, "vae-sd"), exist_ok=True)

    def flush(pixels, names):
        x = torch.from_numpy(np.stack(pixels)).to(device).float() / 127.5 - 1.0
        moments = encoder(x).permute(0, 3, 1, 2).cpu().numpy()  # [B, 8, h, w]
        for name, m in zip(names, moments):
            np.save(os.path.join(dst, "vae-sd", os.path.splitext(name)[0] + ".npy"), m)

    for i in range(0, len(labels), batch_size):
        names = [fname for fname, _ in labels[i:i + batch_size]]
        flush([np.asarray(Image.open(os.path.join(src, "images", n)).convert("RGB"))
               for n in names], names)
    print(f"encoded {len(labels)} images -> {dst}/vae-sd")


def main(argv=None):
    parser = argparse.ArgumentParser("reed_tpu_torch.data.preprocessing")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("convert")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--limit", type=int, default=None)
    p = sub.add_parser("encode")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--vae-npz", default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent fallback")
    args = parser.parse_args(argv)
    if args.cmd == "convert":
        convert(args.src, args.dst, args.resolution, args.limit)
    else:
        encode(args.src, args.dst, args.vae_npz, args.batch_size, args.device)


if __name__ == "__main__":
    main()
