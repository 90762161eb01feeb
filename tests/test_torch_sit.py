"""reed_tpu_torch SiT and its layers against reed_tpu's, same weights and
inputs, f32 on the CPU."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders.sit_convert import convert_torch_sit
from reed_tpu.nn import layers as jl
from reed_tpu_torch.models.sit import SiT_models, create_sit
from reed_tpu_torch.nn import layers as tl
from torch_parity import TINY, tiny_inputs, tiny_pair

torch.set_num_threads(1)

ATOL = 2e-4  # as tests/test_sit_convert.py; measured errors are ~1e-6


def _port(model, x, t, y, **kw):
    with torch.no_grad():
        v, zs = model(torch.tensor(x), torch.tensor(t), torch.tensor(y).long(), **kw)
    return v.numpy(), zs


# std 0.02 is the spec'd draw; at std 0.1 attention moves the output by O(1)
# at this width (at 0.02 by only ~4e-4), so a fault there cannot hide.
@pytest.mark.parametrize("std", [0.02, 0.1])
@pytest.mark.parametrize("exact_gelu", [False, True])
def test_sit_forward_matches_jax(exact_gelu, std):
    jax_model, variables, model = tiny_pair(std=std, exact_gelu=exact_gelu)
    x, t, y = tiny_inputs()
    v_jax, _ = jax_model.apply(variables, x, t, y, train=False)
    v_port, zs = _port(model, x, t, y)
    assert zs is None
    assert v_port.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(v_port, np.asarray(v_jax), atol=ATOL, rtol=0)


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(z_dims=(8, 6), z_types=("i", "t"), encoder_depth=1,
         encoder_depth_text=2),
    dict(z_dims=(8, 6), z_types=("i", "t"), encoder_depth=2,
         encoder_depth_text=2),
])
def test_sit_return_zs_matches_jax(overrides):
    jax_model, variables, model = tiny_pair(std=0.1, **overrides)
    x, t, y = tiny_inputs()
    v_jax, zs_jax = jax_model.apply(variables, x, t, y, train=False,
                                    return_zs=True)
    v_port, zs_port = _port(model, x, t, y, return_zs=True)
    np.testing.assert_allclose(v_port, np.asarray(v_jax), atol=ATOL, rtol=0)
    assert len(zs_port) == len(zs_jax) == len(model.projectors)
    for a, b in zip(zs_port, zs_jax):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


def test_state_dict_round_trip():
    _, variables, model = tiny_pair(
        z_dims=(8, 6), z_types=("i", "t"), encoder_depth_text=2)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_torch_sit(sd, TINY["depth"], num_projectors=2)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_names_and_init():
    model = create_sit("SiT-S/8", input_size=16, num_classes=10)
    keys = set(model.state_dict())
    for k in ("x_embedder.proj.weight", "t_embedder.mlp.0.weight",
              "t_embedder.mlp.2.bias", "y_embedder.embedding_table.weight",
              "blocks.11.adaLN_modulation.1.weight", "blocks.0.attn.qkv.bias",
              "blocks.0.attn.proj.weight", "blocks.0.mlp.fc1.weight",
              "blocks.0.mlp.fc2.bias", "projectors.0.4.weight",
              "final_layer.adaLN_modulation.1.bias", "final_layer.linear.weight"):
        assert k in keys, k
    assert model.x_embedder.proj.weight.shape == (384, 4, 8, 8)
    assert model.y_embedder.embedding_table.weight.shape == (11, 384)
    assert set(SiT_models) == {f"SiT-{s}/{p}" for s in ("XL", "L", "B", "S")
                               for p in (2, 4, 8)}
    model.initialize_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 4)
    v, _ = model(x, torch.rand(2), torch.tensor([1, 10]))
    assert torch.count_nonzero(v) == 0  # zero-init final layer
    assert torch.count_nonzero(model.blocks[0].attn.qkv.weight) > 0


def test_bf16_model_keeps_f32_statistics_and_output():
    _, _, model = tiny_pair(std=0.1)
    x, t, y = tiny_inputs()
    v32, _ = _port(model, x, t, y)
    v16, _ = _port(model.to(torch.bfloat16), x, t, y)
    assert v16.dtype == np.float32
    assert np.abs(v16 - v32).max() < 0.05 * np.abs(v32).max()


@pytest.mark.parametrize("exact", [False, True])
def test_mlp_gelu_matches_jax(exact):
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((2, 5, 8))).astype(np.float32)
    act = jl.gelu_exact if exact else fnn.gelu
    jmlp = jl.Mlp(16, act=act)
    params = jmlp.init(jax.random.PRNGKey(0), x)
    out_jax = np.asarray(jmlp.apply(params, x))
    mlp = tl.Mlp(8, 16, exact_gelu=exact)
    p = params["params"]
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(mlp, name).weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            getattr(mlp, name).bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
        out = mlp(torch.tensor(x)).numpy()
        other = tl.Mlp(8, 16, exact_gelu=not exact)
        other.load_state_dict(mlp.state_dict())
        out_other = other(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, out_jax, atol=1e-5, rtol=0)
    assert np.abs(out_other - out_jax).max() > 1e-4  # the two GELUs differ


def test_layer_functions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    pt = tl.patchify(torch.tensor(x), 4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jl.patchify(x, 4)))
    tokens = rng.standard_normal((2, 16, 4 * 4 * 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.unpatchify(torch.tensor(tokens), 4, 3).numpy(),
        np.asarray(jl.unpatchify(tokens, 4, 3)))
    np.testing.assert_array_equal(tl.unpatchify(tl.patchify(torch.tensor(x[:, :8, :8]), 4), 4, 3).numpy(),
                                  x[:, :8, :8])
    t = np.array([0.0, 0.25, 0.999], np.float32)
    for dim in (256, 7):
        np.testing.assert_allclose(
            tl.timestep_embedding(torch.tensor(t), dim).numpy(),
            np.asarray(jl.timestep_embedding(jnp.asarray(t), dim)), atol=1e-6)
    np.testing.assert_array_equal(tl.get_2d_sincos_pos_embed(64, 4),
                                  jl.get_2d_sincos_pos_embed(64, 4))
    h = rng.standard_normal((2, 5, 6)).astype(np.float32)
    shift, scale = rng.standard_normal((2, 2, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tl.modulate(torch.tensor(h), torch.tensor(shift), torch.tensor(scale)).numpy(),
        np.asarray(jl.modulate(h, shift, scale)), atol=1e-6)
