"""encoders/vit.py and encoders/registry.py against reed_tpu's on the CPU:
a tiny ViT with register tokens from one set of seeded weights in timm
names, carried into reed_tpu by its own convert_torch_vit, in each output
mode and at a grid that resamples the position embeddings; the bicubic
resizes against jax.image.resize at the slice's shapes; and load_encoders
from the npz reed_tpu's save_npz_params writes, with the preprocessing on
the tensor's device. f32 outputs are held to 1e-5 of their max and the
resizes to 1e-5: jax.image.resize's bicubic is Keys a = -0.5 and
antialiased, which torch matches only with antialias=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders import registry as jax_registry
from reed_tpu.encoders import vit as jax_vit
from reed_tpu_torch.encoders import registry, vit
from reed_tpu_torch.tools import seeded_weights

torch.set_num_threads(1)
RTOL = 1e-5
TINY = dict(image_size=16, patch_size=4, hidden_size=32, depth=2, num_heads=4)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("registers,layerscale", [(0, True), (2, True), (1, False)])
def test_vit_matches_reed_tpu_in_every_output_mode(registers, layerscale):
    kw = dict(TINY, num_register_tokens=registers, layerscale=layerscale)
    model = seeded_weights.vit_encoder(vit.ViTConfig(**kw), seed=registers)
    jcfg = jax_vit.ViTConfig(**kw)
    variables = jax_vit.convert_torch_vit({k: v.numpy() for k, v in model.state_dict().items()},
                                          jcfg)
    mine = vit.to_flax(model)
    fa = jax.tree_util.tree_flatten_with_path(variables)[0]
    fb = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(fa, fb))
    back = vit.state_dict_from_flax(variables, model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())

    rng = np.random.default_rng(1)
    for size in (16, 24):  # 24: a 6 x 6 grid resamples the 4 x 4 embeddings
        x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
        for output in ("patch", "cls", "pooled"):
            want = np.asarray(jax_vit.ViT(jcfg).apply(variables, x, output=output))
            with torch.no_grad():
                got = model(torch.from_numpy(x), output=output).numpy()
            assert got.shape == want.shape
            assert _rel(got, want) < RTOL, (size, output)
    with pytest.raises(ValueError):
        model(torch.zeros(1, 16, 16, 3), output="mean")


def test_timm_names():
    names = set(vit.ViT(vit.ViTConfig(**TINY, num_register_tokens=1)).state_dict())
    assert {"patch_embed.proj.weight", "cls_token", "pos_embed", "register_tokens",
            "blocks.1.attn.qkv.weight", "blocks.1.attn.proj.bias", "blocks.0.ls1.gamma",
            "blocks.0.ls2.gamma", "blocks.0.mlp.fc1.weight", "blocks.0.norm2.bias",
            "norm.weight"} <= names


def test_pos_embed_resample_matches_jax():
    """16 x 16 -> 18 x 18 (a DINOv2-B/14 grid at 252 px) and 4 x 4 -> 8 x 8."""
    rng = np.random.default_rng(2)
    for side, target, d in ((16, 18, 64), (4, 8, 8)):
        pos = rng.standard_normal((1, 1 + side * side, d)).astype(np.float32)
        want = np.asarray(jax_vit.resample_pos_embed(jnp.asarray(pos), target, target))
        got = vit.resample_pos_embed(torch.from_numpy(pos), target, target).numpy()
        assert got.shape == want.shape == (1, 1 + target * target, d)
        assert np.abs(got - want).max() < 1e-5
    same = torch.from_numpy(pos)
    assert vit.resample_pos_embed(same, 4, 4) is same


def test_preprocess_256_to_224_matches_jax_resize():
    raw = np.random.default_rng(3).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    for family in ("dinov2", "clip"):
        _, img, _, resize, mean, std = registry.FAMILIES[family]
        want = jax_registry._make_preprocess(np.array(mean, np.float32),
                                             np.array(std, np.float32), img, 256)(raw)
        got = registry._make_preprocess(mean, std, img, 256)(torch.from_numpy(raw)).numpy()
        assert got.shape == want.shape == (2, 224, 224, 3)
        # normalised by std ~0.22, so 1e-5 of the [0, 1] resize is ~5e-5 here
        assert np.abs(got - want).max() < 1e-5 / min(std)
    no_resize = registry._make_preprocess(registry.IMAGENET_MEAN, registry.IMAGENET_STD,
                                          None, 256)(torch.from_numpy(raw))
    assert no_resize.shape == (2, 256, 256, 3)


def test_load_encoders_from_reed_tpus_npz(tmp_path):
    """{encoder_dir}/dinov2-vit-s.npz in save_npz_params' layout: the
    port's in-loop encode of raw uint8 crops matches reed_tpu's forward on
    its own preprocessing."""
    name = "dinov2-vit-s"
    jcfg = jax_vit.ViTConfig(image_size=224, patch_size=14, layerscale=True,
                             **jax_registry._VIT_SIZES["s"])
    model = seeded_weights.vit_encoder(registry.vit_config(name), seed=7)
    variables = jax_vit.convert_torch_vit(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    jax_registry.save_npz_params(str(tmp_path / f"{name}.npz"), variables)

    encoders, types, archs = registry.load_encoders(name, encoder_dir=str(tmp_path),
                                                    device="cpu")
    assert (types, archs, encoders[0].z_dim) == (["dinov2"], ["vit"], 384)
    raw = np.random.default_rng(4).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    (got,) = registry.encode_features(encoders, raw)
    (jax_enc,), _, _ = jax_registry.load_encoders(name, encoder_dir=str(tmp_path))
    want = np.asarray(jax_enc.model.apply(jax_enc.params, jax_enc.preprocess(raw),
                                          output="patch"))
    assert got.shape == want.shape == (2, 256, 384)
    assert _rel(got.numpy(), want) < RTOL
    assert torch.equal(encoders[0].encode(torch.from_numpy(raw)), got)


def test_missing_weights_and_unknown_family():
    encoders, _, _ = registry.load_encoders("dinov2-vit-b,clip-vit-l", device="cpu",
                                            encoder_dir=None)
    assert [e.z_dim for e in encoders] == [768, 1024] and encoders[0].model is None
    with pytest.raises(RuntimeError, match="no weights"):
        encoders[0].encode(np.zeros((1, 256, 256, 3), np.uint8))
    with pytest.raises(NotImplementedError):
        registry.load_encoders("resnet-vit-b", device="cpu")
    assert registry.TEXT_Z_DIM_DICT == jax_registry.TEXT_Z_DIM_DICT
