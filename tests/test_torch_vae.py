"""encoders/vae.py against reed_tpu/encoders/vae.py on the CPU: one set of
seeded weights in diffusers' AutoencoderKL names, carried into reed_tpu by
its own convert_diffusers_vae; the encoder, the decoder, the npz of
tools/convert_vae.py's layout, sample_latents and the uint8 decode.

convert_diffusers_vae walks four stages (SD-VAE's), so the tiny models
keep four stages at base 8 (widths 8, 16, 32, 32). f32 outputs are held
to 1e-5 of their max: both sides compute in f32 and differ by summation
order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders import vae as jax_vae
from reed_tpu.eval.fid import save_params_npz as jax_save_params_npz
from reed_tpu_torch.encoders import flax_tree, vae
from reed_tpu_torch.eval.fid import make_vae_decode_fn
from reed_tpu_torch.tools import seeded_weights

torch.set_num_threads(1)
RTOL = 1e-5
WIDTHS = dict(base_ch=8)


def _same_tree(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("part", ["decoder", "encoder"])
def test_matches_reed_tpu_through_its_converter(part):
    model = (seeded_weights.vae_decoder if part == "decoder"
             else seeded_weights.vae_encoder)(3, **WIDTHS)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax_vae.convert_diffusers_vae(sd, part=part)
    _same_tree(variables, vae.to_flax(model))  # the port's copy of the converter
    back = vae.state_dict_from_flax(variables, model)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())

    rng = np.random.default_rng(1)
    if part == "decoder":
        x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
        want = jax_vae.VAEDecoder(**WIDTHS).apply(variables, x)
        assert want.shape == (2, 32, 32, 3)
    else:
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        want = jax_vae.VAEEncoder(**WIDTHS).apply(variables, x)
        assert want.shape == (2, 4, 4, 8)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert _rel(got.numpy(), want) < RTOL
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # the weights reach the output


def test_any_stage_count_matches_reed_tpu():
    """Two stages, one resnet each (reed_tpu's modules take any; its
    converter walks SD-VAE's four, so the port's copy carries the weights)."""
    widths = dict(base_ch=8, ch_mult=(1, 2), num_res=1)
    rng = np.random.default_rng(6)
    for model, jax_model, shape in (
            (seeded_weights.vae_decoder(6, **widths), jax_vae.VAEDecoder(**widths),
             (2, 4, 4, 4)),
            (seeded_weights.vae_encoder(6, **widths), jax_vae.VAEEncoder(**widths),
             (2, 16, 16, 3))):
        x = rng.standard_normal(shape).astype(np.float32)
        want = jax_model.apply(vae.to_flax(model), x)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.shape == want.shape and _rel(got.numpy(), want) < RTOL


def test_diffusers_names():
    names = set(vae.VAEDecoder(**WIDTHS).state_dict())
    for name in ("post_quant_conv.weight", "decoder.conv_in.weight",
                 "decoder.mid_block.attentions.0.to_q.weight",
                 "decoder.mid_block.attentions.0.to_out.0.bias",
                 "decoder.mid_block.attentions.0.group_norm.weight",
                 "decoder.up_blocks.0.resnets.2.conv2.weight",
                 "decoder.up_blocks.2.resnets.0.conv_shortcut.weight",
                 "decoder.up_blocks.2.upsamplers.0.conv.weight",
                 "decoder.conv_norm_out.bias", "decoder.conv_out.weight"):
        assert name in names, name
    assert "decoder.up_blocks.3.upsamplers.0.conv.weight" not in names
    names = set(vae.VAEEncoder(**WIDTHS).state_dict())
    assert {"quant_conv.weight", "encoder.down_blocks.2.downsamplers.0.conv.weight",
            "encoder.down_blocks.1.resnets.0.conv_shortcut.weight"} <= names
    assert vae.VAEDecoder(**WIDTHS).state_dict()["decoder.mid_block.attentions.0.to_q.weight"
                                                 ].dim() == 2  # Linear, as diffusers


def test_npz_loader_reads_reed_tpus_file_and_decodes_uint8(tmp_path):
    """The flat npz reed_tpu's save_params_npz writes (tools/convert_vae.py)
    loads at the widths it holds; decode_latents and the CLI's decode_fn
    give reed_tpu's uint8 pixels, floats compared before the cast."""
    model = seeded_weights.vae_decoder(4, **WIDTHS)
    variables = jax_vae.convert_diffusers_vae(
        {k: v.numpy() for k, v in model.state_dict().items()}, part="decoder")
    path = str(tmp_path / "vae.npz")
    jax_save_params_npz(path, variables)
    loaded = vae.load_npz(path)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())

    latents = np.random.default_rng(2).standard_normal((2, 4, 4, 4)).astype(np.float32) * 0.2
    want_f = np.asarray(jax_vae.VAEDecoder(**WIDTHS).apply(variables, latents / 0.18215))
    with torch.no_grad():
        got_f = loaded(torch.from_numpy(latents) / 0.18215).numpy()
    assert _rel(got_f, want_f) < RTOL
    want = np.asarray(jax_vae.decode_latents(jax_vae.VAEDecoder(**WIDTHS), variables,
                                             jnp.asarray(latents)))
    got = vae.decode_latents(loaded, torch.from_numpy(latents)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 32, 32, 3)
    # one count where a value sits on a .5 boundary, else equal
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 1e-3
    assert len(np.unique(got)) > 50  # not saturated

    decode_fn = make_vae_decode_fn(path, device="cpu")
    out = decode_fn(torch.from_numpy(latents / 0.18215))
    assert torch.equal(out, vae.to_uint8(loaded(torch.from_numpy(latents / 0.18215))))
    assert make_vae_decode_fn(None, device="cpu") is None


def test_encoder_npz_and_sample_latents(tmp_path):
    model = seeded_weights.vae_encoder(5, **WIDTHS)
    path = str(tmp_path / "enc.npz")
    flax_tree.save_npz(path, vae.to_flax(model))
    loaded = vae.load_npz(path, part="encoder")
    assert isinstance(loaded, vae.VAEEncoder)
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    with torch.no_grad():
        moments = loaded(x)
    eps = np.random.default_rng(3).standard_normal((2, 4, 4, 4)).astype(np.float32)
    got = vae.sample_latents(moments, eps=torch.from_numpy(eps)).numpy()
    mean, logvar = np.split(moments.numpy(), 2, axis=-1)
    want = (mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * eps) * 0.18215
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    drawn = vae.sample_latents(moments, torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 4, 4, 4) and not torch.equal(drawn, torch.from_numpy(got))
