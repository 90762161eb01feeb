"""The image domain's eval and input paths through the port's CLI on the
CPU, at tiny sizes: generate-image --vae (uint8 pixels), compute-fid (stats
and image npz inputs), and train-image with in-loop frozen-encoder
targets, checkpoints, preview sampling and a reference warm start. Where
the inputs can be shared (the VAE weights and latents, FID statistics)
they are held against reed_tpu's."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from reed_tpu.cli import main as jax_main
from reed_tpu.encoders import vae as jax_vae
from reed_tpu.encoders.inception import save_variables_npz
from reed_tpu.eval.fid import save_params_npz
from reed_tpu.eval.frechet import frechet_distance as jax_frechet_distance
from reed_tpu_torch import cli
from reed_tpu_torch.encoders import inception, registry
from reed_tpu_torch.eval import visualize
from reed_tpu_torch.eval.frechet import compute_activation_stats, frechet_distance
from reed_tpu_torch.models import sit as port_sit
from reed_tpu_torch.tools import seeded_weights

torch.set_num_threads(1)
GEN = ["generate-image", "--device", "cpu", "--model", "SiT-S/8", "--num-samples", "3",
       "--batch-size", "2", "--num-steps", "2", "--cfg-scale", "2"]
TINY_SIT = dict(depth=2, hidden_size=64, num_heads=4)
TRAIN = ["train-image", "--device", "cpu", "--model", "SiT-T/2", "--batch-size", "2",
         "--set", "encoder_depth=1", "--set", "num_classes=10", "--set", "projector_dim=16",
         "--set", "curriculum.diffusion_warmup_steps=0", "--set", "z_dims=[384]"]


@pytest.fixture(autouse=True)
def tiny_sit(monkeypatch):
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", TINY_SIT)


def _vae_npz(path, seed=0):
    """A base-8 SD-VAE decoder written as tools/convert_vae.py writes it."""
    model = seeded_weights.vae_decoder(seed, base_ch=8)
    variables = jax_vae.convert_diffusers_vae(
        {k: v.numpy() for k, v in model.state_dict().items()}, part="decoder")
    save_params_npz(str(path), variables)
    return str(path), variables


def test_generate_image_vae_writes_pixels(tmp_path, capsys):
    """--vae: uint8 [N, 256, 256, 3], reed_tpu's decode of the latents the
    same run writes without --vae, to one count."""
    npz, variables = _vae_npz(tmp_path / "vae.npz")
    cli.main(GEN + ["--vae", npz, "--out", str(tmp_path / "pixels.npz")])
    out = capsys.readouterr().out
    assert "imgs/sec with the decode" in out and "WARNING" not in out
    cli.main(GEN + ["--out", str(tmp_path / "latents.npz")])
    assert "WARNING: no --vae" in capsys.readouterr().out
    pixels = np.load(tmp_path / "pixels.npz")["arr_0"]
    latents = np.load(tmp_path / "latents.npz")["arr_0"]
    assert pixels.shape == (3, 256, 256, 3) and pixels.dtype == np.uint8
    assert latents.shape == (3, 32, 32, 4)
    want = np.asarray(jax_vae.decode_latents(jax_vae.VAEDecoder(base_ch=8), variables,
                                             latents * 0.18215))
    diff = np.abs(pixels.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_compute_fid_stats_inputs_match_reed_tpu(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for name, scale in (("a", 1.0), ("b", 1.5)):
        x = rng.standard_normal((200, 6)) * scale + (scale - 1)
        np.savez(tmp_path / f"{name}.npz", mu=x.mean(0), sigma=np.cov(x, rowvar=False))
    args = ["compute-fid", str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]
    jax_main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fid"]
    got = cli.main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fid"] == got
    assert got == pytest.approx(want, rel=1e-12) and got > 0.1


def test_compute_fid_image_inputs(tmp_path, capsys):
    """Image npz inputs through reed_tpu's Inception npz: --save-stats
    writes the port's activation stats, and the printed FID is the port's
    frechet_distance and reed_tpu's on them; without --inception-npz it exits as reed_tpu's does."""
    model = seeded_weights.inception_v3(5)
    save_variables_npz(str(tmp_path / "inc.npz"), inception.to_flax(model))
    rng = np.random.default_rng(6)
    for name in ("a", "b"):
        np.savez(tmp_path / f"{name}.npz",
                 arr_0=rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    fid = cli.main(["compute-fid", str(tmp_path / "a.npz"), str(tmp_path / "b.npz"),
                    "--inception-npz", str(tmp_path / "inc.npz"), "--device", "cpu",
                    "--batch-size", "3", "--save-stats"])
    sa, sb = (np.load(tmp_path / f"{n}_stats.npz") for n in ("a", "b"))
    want = compute_activation_stats(np.load(tmp_path / "a.npz")["arr_0"],
                                    inception.make_feature_fn(model), batch_size=4)
    np.testing.assert_allclose(sa["mu"], want["mu"], rtol=1e-5, atol=1e-6)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fid"] == fid
    assert fid == frechet_distance(sa["mu"], sa["sigma"], sb["mu"], sb["sigma"])
    assert fid == jax_frechet_distance(sa["mu"], sa["sigma"], sb["mu"], sb["sigma"])
    assert np.isfinite(fid) and fid > 0
    with pytest.raises(SystemExit, match="--inception-npz"):
        cli.main(["compute-fid", str(tmp_path / "a.npz"), str(tmp_path / "b_stats.npz"),
                  "--device", "cpu"])


def _image_data(root, n=4):
    rng = np.random.default_rng(0)
    for sub in ("vae-sd", "pixels"):
        (root / sub).mkdir(parents=True)
    labels = []
    for i in range(n):
        np.save(root / "vae-sd" / f"img{i}.npy",
                rng.standard_normal((8, 32, 32)).astype(np.float32))
        np.save(root / "pixels" / f"img{i}.npy",
                rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
        labels.append([f"img{i}.png", i % 10])
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))


def test_train_image_encoder_targets_checkpoints_and_resume(tmp_path, capsys):
    """--enc-type dinov2-vit-s: the frozen encoder's patch features (256
    tokens of 384) are the alignment target; --ckpt-every 2 saves, a second
    call resumes; a missing encoder npz raises as reed_tpu's encode does."""
    data, enc_dir, ckpt = tmp_path / "data", tmp_path / "enc", tmp_path / "ckpt"
    _image_data(data)
    enc_dir.mkdir()
    seeded_weights.save(seeded_weights.vit_encoder(registry.vit_config("dinov2-vit-s"), 1),
                        str(enc_dir / "dinov2-vit-s.npz"))
    args = TRAIN + ["--data-dir", str(data), "--enc-type", "dinov2-vit-s", "--encoder-dir",
                    str(enc_dir), "--log-every", "1", "--ckpt-dir", str(ckpt),
                    "--ckpt-every", "2"]
    state = cli.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert state.step == 2 and "'proj_loss': 0.0," not in out and "imgs/s" in out
    assert {"2.pt", "config.json", "metrics.jsonl"} <= set(os.listdir(ckpt))
    assert json.load(open(ckpt / "config.json"))["z_dims"] == [384]
    state = cli.main(args + ["--steps", "2"])
    assert "resumed from step 2" in capsys.readouterr().out and state.step == 4

    with pytest.raises(RuntimeError, match="no weights"):
        cli.main(TRAIN + ["--data-dir", str(data), "--enc-type", "dinov2-vit-b",
                          "--encoder-dir", str(enc_dir), "--steps", "1"])


def test_train_image_preview_grids(tmp_path, capsys):
    """--sample-every: 16 EMA samples (ODE, 50 steps, CFG 4) as a PNG grid,
    VAE-decoded with --vae, else the first three latent channels."""
    npz, _ = _vae_npz(tmp_path / "vae.npz")
    tiny = [a if a != "SiT-T/2" else "SiT-T/8" for a in TRAIN[:-2]] + [
        "--set", "input_size=8", "--synthetic", "--steps", "2", "--sample-every", "2"]
    for name, extra in (("vae", ["--vae", npz]), ("latent", [])):
        run = tmp_path / name
        cli.main(tiny + ["--ckpt-dir", str(run), *extra])
        assert "saved sample preview" in capsys.readouterr().out
        grid = np.asarray(Image.open(run / "preview_0000002.png"))
        side = 64 if name == "vae" else 8
        assert grid.shape == (4 * side, 4 * side, 3) and grid.dtype == np.uint8
        assert grid.std() > 0


def test_png_writer_round_trips_through_pil(tmp_path):
    rng = np.random.default_rng(9)
    image = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    visualize.write_png(str(tmp_path / "x.png"), image)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), image)
    images = rng.integers(0, 256, (5, 6, 4, 3), dtype=np.uint8)
    visualize.save_image_grid(str(tmp_path / "g" / "grid.png"), images)
    from reed_tpu.eval.visualize import image_grid as jax_image_grid

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g" / "grid.png")),
                                  jax_image_grid(images))


def test_train_image_reference_warm_start(tmp_path):
    """--ref-ckpt: a reference .pt ({'ema': state_dict}, DDP prefix) warm-
    starts the parameters and the EMA, with erf GELU; with lr 0 a step
    leaves the parameters there (and the EMA, up to its decay's rounding)."""
    model = port_sit.create_sit("SiT-T/2", input_size=32, num_classes=10, encoder_depth=1,
                                z_dims=(384,), projector_dim=16)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.02 for k, v in model.state_dict().items()
          if k != "pos_embed"}
    torch.save({"ema": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "ref.pt")
    state = cli.main(TRAIN + ["--synthetic", "--steps", "1", "--lr", "0", "--ref-ckpt",
                              str(tmp_path / "ref.pt")])
    params = dict(state.model.named_parameters())
    assert all(torch.equal(params[k], v) for k, v in sd.items() if k in params)
    for k, v in sd.items():
        if k in state.ema:
            torch.testing.assert_close(state.ema[k], v, rtol=1e-6, atol=1e-9)
    assert state.model.blocks[0].mlp.approximate == "none"
