"""data/preprocessing.py against reed_tpu/data/preprocessing.py on the
CPU: the ADM center crop and the folder conversion give the same pixels
and labels, and `encode` writes the SD-VAE moments [8, h, w] that
reed_tpu's VAEEncoder computes from the same weights (1e-5 of their max:
f32 on both sides) in the layout data/image.py reads."""

import json
import os

import numpy as np
import torch
from PIL import Image

from reed_tpu.data import preprocessing as jax_pre
from reed_tpu.encoders import vae as jax_vae
from reed_tpu_torch.data import image as port_image
from reed_tpu_torch.data import preprocessing
from reed_tpu_torch.encoders import vae
from reed_tpu_torch.tools import seeded_weights

torch.set_num_threads(1)


def _raw_tree(root):
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("n01", "n02")):
        os.makedirs(root / cls)
        for i, shape in enumerate(((90, 70, 3), (40, 50, 3), (130, 64, 3))):
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
                root / cls / f"{i}.png")


def test_center_crop_and_convert_match_reed_tpu(tmp_path):
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (300, 210, 3),
                                                            dtype=np.uint8))
    np.testing.assert_array_equal(preprocessing.center_crop_dhariwal(img, 32),
                                  jax_pre.center_crop_dhariwal(img, 32))
    _raw_tree(tmp_path / "raw")
    preprocessing.convert(str(tmp_path / "raw"), str(tmp_path / "port"), resolution=32,
                          limit=5)
    jax_pre.convert(str(tmp_path / "raw"), str(tmp_path / "ref"), resolution=32, limit=5)
    labels = json.load(open(tmp_path / "port" / "dataset.json"))["labels"]
    assert labels == json.load(open(tmp_path / "ref" / "dataset.json"))["labels"]
    assert len(labels) == 5 and sorted({c for _, c in labels}) == [0, 1]
    for name, _ in labels:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "images" / name)),
                                      np.asarray(Image.open(tmp_path / "ref" / "images" / name)))


def test_encode_writes_reed_tpus_moments(tmp_path):
    _raw_tree(tmp_path / "raw")
    preprocessing.convert(str(tmp_path / "raw"), str(tmp_path / "ds"), resolution=32)
    model = seeded_weights.vae_encoder(2, base_ch=8)
    variables = jax_vae.convert_diffusers_vae(
        {k: v.numpy() for k, v in model.state_dict().items()}, part="encoder")
    jax_pre_npz = str(tmp_path / "enc.npz")
    from reed_tpu.encoders.registry import save_npz_params

    save_npz_params(jax_pre_npz, variables)
    preprocessing.encode(str(tmp_path / "ds"), str(tmp_path / "ds"), jax_pre_npz,
                         batch_size=4, device="cpu")
    labels = json.load(open(tmp_path / "ds" / "dataset.json"))["labels"]
    pixels = np.stack([np.asarray(Image.open(tmp_path / "ds" / "images" / n))
                       for n, _ in labels])
    want = np.asarray(jax_vae.VAEEncoder(base_ch=8).apply(
        variables, pixels.astype(np.float32) / 127.5 - 1.0)).transpose(0, 3, 1, 2)
    got = np.stack([np.load(tmp_path / "ds" / "vae-sd" / (n[:-4] + ".npy")) for n, _ in labels])
    assert got.shape == want.shape == (6, 8, 4, 4)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    # the data pipeline reads them back as latents
    ds = port_image.CachedLatentDataset(port_image.ImageDatasetConfig(str(tmp_path / "ds")))
    (batch,) = list(port_image.epoch_batches(ds, 6, 0))
    assert batch["x"].shape == (6, 4, 4, 4)
    assert isinstance(vae.load_npz(jax_pre_npz, part="encoder"), vae.VAEEncoder)
