"""The port's configlib (reed_tpu_torch/core/configlib.py) against
reed_tpu's: the same dicts, overrides and recipe files resolve to the same
values in both frameworks' config dataclasses, and the CLI resolves
defaults <- --config <- flags <- --set as reed_tpu's does."""

import dataclasses
import json
import os

import pytest
import torch

from reed_tpu.core import configlib as jax_configlib
from reed_tpu.train.image import ImageTrainConfig as JaxImageConfig
from reed_tpu.train.protein import ProteinTrainConfig as JaxProteinConfig
from reed_tpu_torch import cli
from reed_tpu_torch.core import configlib
from reed_tpu_torch.train.image import ImageTrainConfig
from reed_tpu_torch.train.protein import ProteinTrainConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"image_sitxl_reed.json": (ImageTrainConfig, JaxImageConfig),
         "protein_fmif_reed.json": (ProteinTrainConfig, JaxProteinConfig)}


def _shared(port_cfg, jax_cfg):
    """The fields both configs have, as plain dicts, recursively."""
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)

    def common(x, y):
        return {k: common(x[k], y[k]) if isinstance(x[k], dict) else x[k]
                for k in x if k in y}

    return common(a, b), common(b, a)


@pytest.mark.parametrize("recipe", sorted(PAIRS))
def test_recipes_load_as_in_reed_tpu(recipe):
    port_cls, jax_cls = PAIRS[recipe]
    data = configlib.load_file(os.path.join(REPO, "recipes", recipe))
    port = configlib.merge(port_cls(), data)
    ref = jax_configlib.merge(jax_cls(), data)
    mine, theirs = _shared(port, ref)
    assert mine == theirs
    # every key of the recipe is a field of the port's config
    assert configlib.build(port_cls, data) == port


def test_build_nested_and_unknown_keys():
    cfg = configlib.build(ImageTrainConfig, {
        "model": "SiT-L/2", "optim": {"lr": 3e-4},
        "loss": {"enc_names": ["dinov2", "clip"], "loss_weights": [1, 0.5]}})
    assert (cfg.model, cfg.optim.lr, cfg.optim.b1) == ("SiT-L/2", 3e-4, 0.9)
    assert cfg.loss.enc_names == ("dinov2", "clip")
    with pytest.raises(KeyError, match="unknown config key"):
        configlib.build(ImageTrainConfig, {"modle": "SiT-L/2"})
    with pytest.raises(KeyError, match="unknown config key"):
        configlib.merge(ImageTrainConfig(), {"optim": {"lrr": 1}})


def test_overrides_match_reed_tpu():
    overrides = ["optim.lr=3e-4", "curriculum.diffusion_warmup_steps=50000",
                 "model=SiT-XL/2", "z_dims=[768, 3584]", "exact_gelu=true",
                 "loss.enc_names=[\"dinov2\",\"qwen7b\"]", "optim.grad_clip=1",
                 "optim.mu_dtype=bfloat16"]
    port = configlib.apply_overrides(ImageTrainConfig(), overrides)
    ref = jax_configlib.apply_overrides(JaxImageConfig(), overrides)
    mine, theirs = _shared(port, ref)
    assert mine == theirs
    assert port.z_dims == (768, 3584) and port.optim.grad_clip == 1.0
    assert isinstance(port.optim.grad_clip, float)
    with pytest.raises(ValueError, match="key=value"):
        configlib.apply_overrides(port, ["optim.lr"])
    with pytest.raises(KeyError):
        configlib.apply_overrides(port, ["optim.lrr=1"])


def test_snapshot_round_trip(tmp_path):
    cfg = configlib.apply_overrides(ProteinTrainConfig(), ["optim.lr=7e-4",
                                                           "interpolant.temp=0.5"])
    path = configlib.snapshot(cfg, str(tmp_path))
    assert configlib.merge(ProteinTrainConfig(), json.load(open(path))) == cfg
    assert json.loads(configlib.to_json(cfg))["interpolant"]["temp"] == 0.5


def test_cli_resolves_defaults_file_flags_then_set(tmp_path, capsys):
    """--config, then an explicit flag over it, then --set over both."""
    path = tmp_path / "protein.json"
    path.write_text(json.dumps({"hidden_dim": 48, "batch_size": 3, "seed": 5,
                                "num_encoder_layers": 1, "num_decoder_layers": 1,
                                "k_neighbors": 4, "max_len": 16, "single_dim": 8,
                                "pair_dim": 4, "structure_dim": 8}))
    state = cli.main(["train-protein", "--device", "cpu", "--steps", "1", "--synthetic",
                      "--config", str(path), "--batch-size", "2", "--ckpt-dir",
                      str(tmp_path / "run"), "--set", "hidden_dim=32",
                      "--set", "optim.lr=5e-4"])
    snap = json.load(open(tmp_path / "run" / "config.json"))
    assert (snap["hidden_dim"], snap["batch_size"], snap["seed"]) == (32, 2, 5)
    assert snap["optim"]["lr"] == 5e-4 and snap["optim"]["grad_clip"] == 1.0
    assert state.model.node_embeds.shape == (32,) and state.step == 1
    assert "[step 1]" in capsys.readouterr().out
