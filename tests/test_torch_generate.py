"""The port's generate-image entry point on the CPU, and its refusal to fall
back to the CPU when CUDA was asked for (the default) and is missing."""

import numpy as np
import pytest
import torch

from reed_tpu_torch import cli
from reed_tpu_torch.eval.fid import (batch_generator, load_params_npz,
                                     save_params_npz, strip_projector_params)

torch.set_num_threads(1)

ARGS = ["generate-image", "--model", "SiT-S/8", "--num-samples", "2",
        "--batch-size", "2", "--num-steps", "2"]


def test_generate_image_on_cpu_writes_latents(tmp_path):
    out = tmp_path / "samples.npz"
    cli.main(ARGS + ["--device", "cpu", "--cfg-scale", "2", "--out", str(out)])
    arr = np.load(out)["arr_0"]
    assert arr.shape == (2, 32, 32, 4)
    assert np.isfinite(arr).all()


def test_generate_image_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(ARGS + ["--out", str(tmp_path / "samples.npz")])
    assert not (tmp_path / "samples.npz").exists()


def test_generate_image_from_reference_checkpoint(tmp_path):
    """A reference-layout .pt ({'ema': state_dict} with the DDP 'module.'
    prefix, the fixed pos_embed and two projectors) loads into the CLI's
    model, and the loaded weights drive the sampler."""
    from reed_tpu_torch.encoders.sit_convert import load_reference_checkpoint
    from reed_tpu_torch.models.sit import create_sit

    ref = create_sit("SiT-S/8", z_dims=(8, 6), projector_dim=16)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.02
          for k, v in ref.state_dict().items()}
    ckpt = {"ema": {f"module.{k}": v for k, v in sd.items()},
            "args": {"model": "SiT-S/8"}}
    ckpt["ema"]["module.pos_embed"] = torch.zeros(1, 16, 384)
    path = tmp_path / "ref.pt"
    torch.save(ckpt, path)

    loaded = load_reference_checkpoint(str(path))
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)

    out = tmp_path / "samples.npz"
    cli.main(ARGS + ["--device", "cpu", "--dtype", "float32", "--ref-ckpt",
                     str(path), "--out", str(out)])
    from_ckpt = np.load(out)["arr_0"]
    cli.main(ARGS + ["--device", "cpu", "--dtype", "float32",
                     "--out", str(out)])
    from_init = np.load(out)["arr_0"]
    assert np.isfinite(from_ckpt).all()
    assert np.abs(from_ckpt - from_init).max() > 1e-3  # the weights mattered


def test_batch_generator_depends_on_seed_and_index():
    draws = {(s, i): torch.randn(4, generator=batch_generator(s, i, "cpu"))
             for s in (0, 1) for i in (0, 1)}
    assert torch.equal(draws[0, 1], torch.randn(4, generator=batch_generator(0, 1, "cpu")))
    values = list(draws.values())
    assert all(not torch.equal(a, b) for j, a in enumerate(values)
               for b in values[j + 1:])


def test_params_npz_round_trip_and_projector_strip(tmp_path):
    sd = {"blocks.0.attn.qkv.weight": torch.randn(6, 2),
          "projectors.0.0.weight": torch.randn(3, 2)}
    assert list(strip_projector_params(sd)) == ["blocks.0.attn.qkv.weight"]
    save_params_npz(str(tmp_path / "p.npz"), sd)
    back = load_params_npz(str(tmp_path / "p.npz"))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])
