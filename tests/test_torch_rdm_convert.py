"""A reference-layout RDM checkpoint (GeoRCG's LatentDiffusion: the
SimpleMLP under `model.diffusion_model.`, its EMA copy under `model_ema.`,
the atom-count ClassEmbedder's table `cond_stage_model.embedding.weight`
one row shorter than reed_tpu's, the whole under `state_dict`, with or
without a `module.` prefix, or a bare SimpleMLP dict) loads into the
port's SimpleMLP, and the same file loads into reed_tpu's through
load_torch_rdm_checkpoint; the two forwards agree to 1e-5 of their max,
the padded class row is zero, and the widths read off the file are the
model's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders.rdm_convert import load_torch_rdm_checkpoint
from reed_tpu.models.rdm_mlp import SimpleMLP as JaxMLP
from reed_tpu_torch.encoders import rdm_convert
from reed_tpu_torch.models.rdm_mlp import SimpleMLP

torch.set_num_threads(1)
RTOL = 1e-5
TINY = dict(in_channels=8, time_embed_dim=16, model_channels=32, bottleneck_channels=24,
            out_channels=8, num_res_blocks=3, num_classes=12, context_channels=8)


def _reference_state_dict(seed=0):
    """A LatentDiffusion state dict: the denoiser's keys prefixed, an EMA
    copy, and a class table of num_classes rows (the port's has one more)."""
    model = SimpleMLP(**TINY)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        base = 1.0 if k.endswith("layers.0.weight") or k == "out.0.weight" else 0.0
        w = base + 0.2 * torch.randn(v.shape, generator=g)
        if k == rdm_convert.EMBEDDING:
            sd[k] = w[:TINY["num_classes"]]
        else:
            sd[f"model.diffusion_model.{k}"] = w
            sd[f"model_ema.diffusion_model{k.replace('.', '')}"] = w + 1.0
    return sd


@pytest.mark.parametrize("layout", ["state_dict", "module_prefix", "bare"])
def test_reference_checkpoint_loads_into_both(tmp_path, layout):
    sd = _reference_state_dict()
    if layout == "module_prefix":
        ckpt = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    elif layout == "bare":
        ckpt = {k[len("model.diffusion_model."):] if k.startswith("model.diffusion_model.")
                else k: v for k, v in sd.items() if not k.startswith("model_ema.")}
    else:
        ckpt = {"state_dict": sd, "epoch": 3}
    path = str(tmp_path / "rdm.ckpt")
    torch.save(ckpt, path)

    rows = TINY["num_classes"] + 1
    ours = rdm_convert.strip_state_dict(rdm_convert.read_checkpoint(path), num_rows=rows)
    w = rdm_convert.widths(ours)
    assert w == {k: v for k, v in dict(TINY, use_context=True).items() if k != "num_classes"}
    table = ours[rdm_convert.EMBEDDING]
    assert table.shape == (rows, 8) and (table[-1] == 0).all()
    assert torch.equal(table[:-1], sd[rdm_convert.EMBEDDING])
    model = SimpleMLP(**TINY)
    model.load_state_dict(ours)
    model.eval()

    params = jax.tree.map(jnp.asarray, load_torch_rdm_checkpoint(path, num_classes=rows))
    r = np.random.default_rng(1)
    x = r.standard_normal((5, 8)).astype(np.float32)
    t = r.integers(0, 1000, size=5).astype(np.int32)
    n = np.array([0, 3, 7, 11, 12], np.int32)
    want = np.asarray(JaxMLP(**TINY).apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(n)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(n).long()).numpy()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= RTOL * scale, (err, scale)


def test_port_state_dict_is_reference_layout():
    """reed_tpu's converter reads the port's own state_dict unchanged."""
    from reed_tpu.encoders.rdm_convert import convert_torch_rdm

    model = SimpleMLP(**TINY).initialize_weights(torch.Generator().manual_seed(2))
    params = convert_torch_rdm(model.state_dict())
    assert sorted(params) == sorted(
        ["time_fc1", "time_fc2", "input_proj", "out_norm", "out_fc", "class_embedder"]
        + [f"res_{i}" for i in range(TINY["num_res_blocks"])])
    assert params["class_embedder"]["embedding"].shape == (TINY["num_classes"] + 1, 8)
    assert sorted(params["res_0"]) == ["context_fc", "emb_fc", "in_fc", "in_norm",
                                       "out_fc", "out_norm"]
