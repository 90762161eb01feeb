"""reed_tpu_torch's EGNNDynamics against reed_tpu's on the CPU: a tiny
model (hidden 32, 2 blocks of 2 GCLs, batch 3 x 9 atoms with padded rows)
whose every weight, coord_mlp.4 (the gain-1e-3 coordinate head) and
fake_latent included, is drawn from a seeded normal on the port's side and
carried to reed_tpu by reed_tpu's own converter. Outputs agree to 1e-5 of
their max with the rep on and off, attention and tanh on and off, sum and
mean aggregation, a per-node context, a learned fake latent in training
(with the dropout mask handed over) and forward_with_cfg; then E(3)
equivariance, the factored first layer against the concat, and the
initialisation's scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.models.egnn import EGNNDynamics as JaxDynamics
from reed_tpu_torch.models import egnn
from torch_parity import EDM_TINY, edm_inputs, edm_pair

torch.set_num_threads(1)
RTOL = 1e-5

CONFIGS = {
    "default": ({}, {}),
    "no_rep": (dict(rep_nf=None), dict(rep_nf=0)),
    "no_attention_no_tanh": (dict(attention=False, tanh=False), {}),
    "mean_aggregation": (dict(aggregation="mean", normalization_factor=100.0), {}),
    "context": (dict(context_node_nf=2), dict(context_nf=2)),
    "one_sublayer_two_attn_blocks": (dict(inv_sublayers=1, attn_block_num=2), {}),
}


def _close(name, ours, ref):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(ours - ref).max()
    assert np.isfinite(ours).all() and err <= RTOL * scale, (name, err, scale)


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reed_tpu(name):
    model_kw, input_kw = CONFIGS[name]
    jax_model, params, model = edm_pair(**model_kw)
    inputs = edm_inputs(**input_kw)
    want = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)},
                           **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = model(**_torch(inputs))
    _close(name, got, want)
    pad = inputs["node_mask"][..., 0] == 0
    assert pad.any() and (got.numpy()[pad] == 0).all()


def test_training_rep_dropout_matches_reed_tpu():
    """In training the rows reed_tpu drops take fake_latent; the mask is
    read off the rep reed_tpu's EGNN receives and handed to the port."""
    import flax.linen as nn

    jax_model, params, model = edm_pair()
    inputs = edm_inputs(batch=6)
    seen = {}

    def capture(next_fun, args, kwargs, context):
        if type(context.module).__name__ == "EGNN":
            seen["rep"] = np.asarray(kwargs["rep"])
        return next_fun(*args, **kwargs)

    fake = np.asarray(params["fake_latent"])
    jparams = jax.tree.map(jnp.asarray, params)
    for key in range(50):   # a key that drops some rows and keeps others
        with nn.intercept_methods(capture):
            want = jax_model.apply({"params": jparams},
                                   **{k: jnp.asarray(v) for k, v in inputs.items()},
                                   train=True, rngs={"rep_dropout": jax.random.PRNGKey(key)})
        drop = np.all(seen["rep"] == fake, axis=-1)
        if 0 < drop.sum() < len(drop):
            break
    assert 0 < drop.sum() < len(drop)
    assert (drop | np.all(seen["rep"] == inputs["rep"], axis=-1)).all()
    with torch.no_grad():
        got = model(**_torch(inputs), train=True, drop=torch.from_numpy(drop))
    _close("train", got, want)
    # without a mask the port draws one: all rows kept at p = 0 is the eval output
    model.rep_dropout_prob = 0.0
    with torch.no_grad():
        kept = model(**_torch(inputs), train=True)
        plain = model(**_torch(inputs))
    assert torch.equal(kept, plain)


def test_forward_with_cfg_matches_reed_tpu():
    jax_model, params, model = edm_pair()
    inputs = edm_inputs()
    args = [jnp.asarray(inputs[k]) for k in ("t", "xh", "node_mask", "edge_mask")]
    want = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)}, *args, None,
                           jnp.asarray(inputs["rep"]), 2.5,
                           method=JaxDynamics.forward_with_cfg)
    x = _torch(inputs)
    with torch.no_grad():
        got = model.forward_with_cfg(x["t"], x["xh"], x["node_mask"], x["edge_mask"], None,
                                     x["rep"], 2.5)
    _close("cfg", got, want)


def test_equivariance():
    """Rotating and translating the input coordinates rotates the velocity
    (zero CoM) and leaves the feature outputs unchanged."""
    _, _, model = edm_pair()
    x = _torch(edm_inputs())
    rot = torch.from_numpy(np.linalg.qr(np.random.default_rng(3).standard_normal(
        (3, 3)))[0].astype(np.float32))
    moved = dict(x)
    mask = x["node_mask"]
    moved["xh"] = torch.cat([(x["xh"][..., :3] @ rot.T + torch.tensor([0.5, -1.0, 2.0]))
                             * mask, x["xh"][..., 3:]], -1)
    with torch.no_grad():
        out, out_moved = model(**x), model(**moved)
    np.testing.assert_allclose(out_moved[..., :3].numpy(), (out[..., :3] @ rot.T).numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(out_moved[..., 3:].numpy(), out[..., 3:].numpy(), atol=2e-5)


def test_factored_pair_linear_matches_concat():
    gen = torch.Generator().manual_seed(0)
    layer = torch.nn.Linear(2 * 8 + 2, 5)
    h = torch.randn((2, 4, 8), generator=gen)
    e = torch.randn((2, 4, 4, 2), generator=gen)
    cat = torch.cat([h[:, :, None].expand(2, 4, 4, 8), h[:, None].expand(2, 4, 4, 8), e], -1)
    np.testing.assert_allclose(egnn.factored_pair_linear(layer, h, e).detach().numpy(),
                               layer(cat).detach().numpy(), rtol=1e-5, atol=1e-6)


def test_initialisation_scales():
    """lecun-normal linears with zero biases, the coordinate heads uniform
    within xavier's bound at gain 1e-3, fake_latent N(0, 0.02), unit norms;
    the same generator seed gives the same weights."""
    def build(seed):
        return egnn.EGNNDynamics(**dict(EDM_TINY, hidden_nf=64)).initialize_weights(
            torch.Generator().manual_seed(seed))

    model = build(0)
    sd = model.state_dict()
    head = sd["egnn.e_block_0.gcl_equiv.coord_mlp.4.weight"]
    assert head.abs().max() <= 1e-3 * np.sqrt(6.0 / (64 + 1)) and head.abs().max() > 0
    w = sd["egnn.e_block_0.gcl_0.edge_mlp.2.weight"]
    assert abs(w.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert (sd["egnn.e_block_0.gcl_0.edge_mlp.2.bias"] == 0).all()
    assert abs(sd["fake_latent"].std().item() - 0.02) < 0.01
    assert (sd["egnn.attns.0.0.norm3.weight"] == 1).all()
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), build(0).state_dict().values()))
