"""reed_tpu_torch's image loss pieces against reed_tpu's on the CPU:
sample_time, mean_flat, cosine_alignment and flow_matching_loss with
reed_tpu's draws handed over (t, eps), and the CFG label dropout of
LabelEmbedder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import continuous as jc
from reed_tpu.diffusion.paths import sample_time as jax_sample_time
from reed_tpu_torch.diffusion import continuous as tc
from reed_tpu_torch.diffusion.paths import sample_time
from reed_tpu_torch.nn.layers import LabelEmbedder

torch.set_num_threads(1)


@pytest.mark.parametrize("weighting,path_type", [
    ("uniform", "linear"), ("lognormal", "linear"), ("lognormal", "cosine")])
def test_sample_time_matches_jax(weighting, path_type):
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax_sample_time(rng, 64, weighting, path_type))
    draw = (jax.random.uniform(rng, (64,)) if weighting == "uniform"
            else jax.random.normal(rng, (64,)))
    got = sample_time(None, 64, weighting, path_type, draw=torch.tensor(np.asarray(draw)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    drawn = sample_time(torch.Generator().manual_seed(0), 4096, weighting, path_type)
    assert drawn.dtype == torch.float32 and 0.0 < drawn.min() and drawn.max() < 1.0
    if weighting == "uniform":
        assert abs(drawn.mean().item() - 0.5) < 0.02
    else:  # sigma = exp(N(0, 1)) has median 1: t's median is 0.5
        assert abs(drawn.median().item() - 0.5) < 0.03
    with pytest.raises(NotImplementedError):
        sample_time(None, 4, "beta", path_type)


def test_mean_flat_and_cosine_alignment_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(tc.mean_flat(torch.tensor(x)).numpy(),
                               np.asarray(jc.mean_flat(x)), rtol=1e-6, atol=1e-7)
    z = rng.standard_normal((3, 6, 8)).astype(np.float32)
    zt = rng.standard_normal((3, 6, 8)).astype(np.float32)
    z[0, 2] = 0.0   # a zero target and a zero prediction: eps keeps them at 0
    zt[1, 3] = 0.0
    pooled, pooled_t = z[:, 0].copy(), zt[:, 1].copy()
    pooled[2] = 0.0
    for a, b in ((z, zt), (pooled, pooled_t), (z, pooled_t), (pooled, zt)):
        got = tc.cosine_alignment(torch.tensor(a), torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(jc.cosine_alignment(a, b)),
                                   rtol=1e-6, atol=1e-7)
    assert tc.cosine_alignment(torch.tensor(pooled), torch.tensor(pooled_t))[2] == 0.0
    same = tc.cosine_alignment(torch.tensor(z[1:]), torch.tensor(z[1:]))
    np.testing.assert_allclose(same.numpy(), -1.0, atol=1e-6)


LOSS_CASES = {
    "one_encoder": dict(enc_names=("dinov2",), loss_weights=(1.0,)),
    "one_text_encoder_counts_as_image": dict(enc_names=("qwen",), loss_weights=(0.7,)),
    "two_encoders": dict(enc_names=("dinov2", "qwen"), loss_weights=(1.0, 0.5)),
    "base_weight_0": dict(enc_names=("dinov2", "qwen"), loss_weights=(0.0, 0.5),
                          time_schedule="linear"),
    "cosine_path_lognormal": dict(enc_names=("mocov3", "t5"), loss_weights=(0.3, 0.5),
                                  path_type="cosine", weighting="lognormal"),
    **{f"schedule_{k}": dict(enc_names=("dinov2", "qwen"), loss_weights=(1.0, 0.5),
                             time_schedule=k, cutoffs=(0.2, 0.7))
       for k in ("constant", "linear", "cosine", "sigmoid", "loglinear", "cutoff")},
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_flow_matching_loss_matches_jax(name):
    kw = LOSS_CASES[name]
    rng = np.random.default_rng(1)
    b, tokens = 6, 4
    x = rng.standard_normal((b, 4, 4, 2)).astype(np.float32)
    dims = [(tokens, 8) if i == 0 else (5,) for i in range(len(kw["enc_names"]))]
    zs = [rng.standard_normal((b,) + d).astype(np.float32) for d in dims]
    zs_tilde = [rng.standard_normal((b,) + d).astype(np.float32) for d in dims]
    w = rng.standard_normal((4, 4, 2)).astype(np.float32)

    def jax_model(x_t, t, rng_model):
        return x_t * w + t[:, None, None, None], [jnp.asarray(z) for z in zs_tilde]

    def port_model(x_t, t):
        return (x_t * torch.tensor(w) + t[:, None, None, None],
                [torch.tensor(z) for z in zs_tilde])

    cfg_j, cfg_t = jc.FlowMatchingLossConfig(**kw), tc.FlowMatchingLossConfig(**kw)
    key = jax.random.PRNGKey(5)
    want = jc.flow_matching_loss(cfg_j, jax_model, jnp.asarray(x),
                                 [jnp.asarray(z) for z in zs], key)
    # the draws flow_matching_loss takes from its key
    rng_t, rng_eps, _ = jax.random.split(key, 3)
    t = jax_sample_time(rng_t, b, cfg_j.weighting, cfg_j.path_type)
    eps = jax.random.normal(rng_eps, x.shape)
    got = tc.flow_matching_loss(cfg_t, port_model, torch.tensor(x),
                                [torch.tensor(z) for z in zs],
                                t=torch.tensor(np.asarray(t)), eps=torch.tensor(np.asarray(eps)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if kw["enc_names"] == ("qwen",):
        assert float(got["text_proj_loss"]) == 0.0 and float(got["img_proj_loss"]) != 0.0


def test_flow_matching_loss_is_f32_for_a_bf16_model_and_draws_from_a_generator():
    cfg = tc.FlowMatchingLossConfig()
    x = torch.randn(4, 2, 2, 3)
    z = torch.randn(4, 1, 5)

    def model(x_t, t):
        return x_t.to(torch.bfloat16), [z.to(torch.bfloat16)]

    a = tc.flow_matching_loss(cfg, model, x, [z], generator=torch.Generator().manual_seed(0))
    b = tc.flow_matching_loss(cfg, model, x, [z], generator=torch.Generator().manual_seed(0))
    c = tc.flow_matching_loss(cfg, model, x, [z], generator=torch.Generator().manual_seed(1))
    assert all(v.dtype == torch.float32 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["denoising_loss"], c["denoising_loss"])
    np.testing.assert_allclose(float(a["proj_loss"]), -1.0, atol=1e-2)


def test_label_dropout_rate_null_class_and_eval():
    emb = LabelEmbedder(10, 4, dropout_prob=0.25)
    with torch.no_grad():
        emb.embedding_table.weight.copy_(torch.arange(11.0)[:, None].expand(11, 4))
    y = torch.randint(0, 10, (20000,), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    out = emb(y, torch.float32, train=True, generator=gen)[:, 0].long()
    dropped = out == 10
    assert abs(dropped.float().mean().item() - 0.25) < 0.01
    assert torch.equal(out[~dropped], y[~dropped])
    # outside training, or with dropout 0, nothing is dropped
    assert torch.equal(emb(y, torch.float32)[:, 0].long(), y)
    no_cfg = LabelEmbedder(10, 4, dropout_prob=0.0)
    assert no_cfg.embedding_table.weight.shape[0] == 10
    assert torch.equal(no_cfg(y[:50], torch.float32, train=True),
                       no_cfg(y[:50], torch.float32))
    # an injected mask replaces the draw; the output takes the asked dtype
    drop = torch.zeros(20000, dtype=torch.bool)
    drop[:3] = True
    out = emb(y, torch.bfloat16, train=True, drop=drop)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[:, 0].long(), torch.where(drop, 10, y))
