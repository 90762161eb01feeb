"""reed_tpu_torch's EGNNDynamics against reed_tpu's on the CPU: a tiny
model (hidden 32, 2 blocks of 2 GCLs, batch 3 x 9 atoms with padded rows)
whose every weight, the coordinate heads (coord_mlp.4) and fake_latent
included, is drawn from a seeded normal on the port's side and
carried to reed_tpu by reed_tpu's own converter. Outputs agree to 1e-5 of
their max with the rep on and off, attention and tanh on and off, sum and
mean aggregation, a per-node context, a learned fake latent in training
(with the dropout mask handed over) and forward_with_cfg; then E(3)
equivariance, the factored first layer against the concat, and the
initialisation's scales; the coordinate heads' distribution against
reed_tpu's at the EDM gate's width (hidden 256), each from its own seed:
bound and variance agree within sampling error, which the reference
torch EDM's gain-1e-3 draw does not; and which products run in bf16 under
compute_dtype bfloat16."""

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
    within reed_tpu's variance_scaling bound, fake_latent N(0, 0.02), unit norms;
    the same generator seed gives the same weights."""
    def build(seed):
        return egnn.EGNNDynamics(**dict(EDM_TINY, hidden_nf=64)).initialize_weights(
            torch.Generator().manual_seed(seed))

    model = build(0)
    sd = model.state_dict()
    head = sd["egnn.e_block_0.gcl_equiv.coord_mlp.4.weight"]
    assert head.abs().max() <= np.sqrt(6e-6 / ((64 + 1) / 2)) and head.abs().max() > 0
    w = sd["egnn.e_block_0.gcl_0.edge_mlp.2.weight"]
    assert abs(w.std().item() - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert (sd["egnn.e_block_0.gcl_0.edge_mlp.2.bias"] == 0).all()
    assert abs(sd["fake_latent"].std().item() - 0.02) < 0.01
    assert (sd["egnn.attns.0.0.norm3.weight"] == 1).all()
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), build(0).state_dict().values()))


def _head_matches(w: np.ndarray, limit: float) -> bool:
    """Whether the draws w look like Uniform(-limit, limit): none beyond it,
    the largest within 10 % of it, and the variance limit^2 / 3 within 10 %
    (about 4 standard errors at 1,536 draws; the mean within 4)."""
    w = np.asarray(w, np.float64).ravel()
    var = limit ** 2 / 3
    return bool(np.abs(w).max() <= limit * (1 + 1e-6) and np.abs(w).max() > 0.9 * limit
                and abs(w.var() / var - 1) < 0.1
                and abs(w.mean()) < 4 * np.sqrt(var / w.size))


def test_coordinate_head_init_matches_reed_tpu():
    """reed_tpu's EquivariantUpdate draws coord_out from variance_scaling(
    1e-3 ** 2 * 2, fan_avg, uniform): bound sqrt(3 * 2e-6 / fan_avg). The
    port's six heads at the gate's width and six reed_tpu inits (each from
    its own seed) both match that uniform; the gain-1e-3 draw does not."""
    from reed_tpu.models.egnn import EquivariantUpdate

    hidden = 256
    limit = np.sqrt(3 * 2e-6 / ((hidden + 1) / 2))
    model = egnn.EGNNDynamics(in_node_nf=6, hidden_nf=hidden, n_layers=6, inv_sublayers=1,
                              rep_nf=None).initialize_weights(torch.Generator().manual_seed(3))
    ours = np.concatenate([model.state_dict()[f"egnn.e_block_{i}.gcl_equiv.coord_mlp.4.weight"]
                           .numpy().ravel() for i in range(6)])
    h = jnp.zeros((1, 2, hidden))
    x = jnp.zeros((1, 2, 3))
    pair = jnp.zeros((1, 2, 2, 2))
    mask, emask = jnp.ones((1, 2, 1)), jnp.ones((1, 2, 2, 1))
    ref = np.concatenate([
        np.asarray(EquivariantUpdate(hidden).init(jax.random.PRNGKey(k), h, x, pair[..., :1]
                                                  .repeat(3, -1), pair, mask, emask)
                   ["params"]["coord_out"]["kernel"]).ravel() for k in range(6)])
    assert ours.size == ref.size == 6 * hidden
    assert _head_matches(ref, limit), "reed_tpu's draw"
    assert _head_matches(ours, limit), "the port's draw"
    old = 1e-3 * np.sqrt(6.0 / (hidden + 1))
    gain_1e3 = torch.empty(6 * hidden).uniform_(-old, old, generator=torch.Generator()
                                                .manual_seed(3)).numpy()
    assert not _head_matches(gain_1e3, limit)


def test_bf16_compute_dtypes():
    """compute_dtype bfloat16 as flax's Dense(dtype=bf16) in reed_tpu: every
    product of the EGNN takes bf16-rounded weights, the edge and node MLPs,
    the coordinate heads and the rep attention compute in bf16 (only the
    factored first layer's node halves meet f32 features in f32), while the
    masked features, the coordinates, the output and the parameters'
    gradients stay f32; compute_dtype float32 runs no product in bf16."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class Products(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is F.linear:
                x, w = args[0], args[1]
                self.calls.append((x.dtype, w.dtype,
                                   bool(torch.equal(w, w.to(torch.bfloat16).to(w.dtype)))))
            return func(*args, **kwargs)

    inputs = _torch(edm_inputs())
    for dtype in (torch.bfloat16, torch.float32):
        model = egnn.EGNNDynamics(**EDM_TINY, compute_dtype=dtype).eval()
        _, _, ref = edm_pair()
        model.load_state_dict(ref.state_dict())
        seen = {}

        def record(name):
            def hook(module, args, out):
                seen.setdefault(name, set()).update(
                    t.dtype for t in (out if isinstance(out, tuple) else (out,)))
            return hook

        for m in model.modules():
            if isinstance(m, (egnn.GCL, egnn.EquivariantUpdate)):
                m.register_forward_hook(record(type(m).__name__))
        with Products() as products:
            out = model(**inputs)
        out.abs().sum().backward()
        bf16 = [c for c in products.calls if c[0] == torch.bfloat16]
        assert out.dtype == torch.float32 and seen == {"GCL": {torch.float32},
                                                       "EquivariantUpdate": {torch.float32}}
        # (fake_latent and the one-key attention's q, k and norm2 get none)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        assert len(grads) > 50 and all(g.dtype == torch.float32 for g in grads)
        if dtype == torch.bfloat16:
            # per GCL: the edge half of edge_mlp.0, edge_mlp.2, att_mlp,
            # node_mlp.0 and .2; per coordinate update: coord_mlp.0's edge
            # half, .2 and .4; embedding, embedding_out and 4 in each rep block
            n_bf16 = (EDM_TINY["n_layers"] * (EDM_TINY["inv_sublayers"] * 5 + 3 + 4) + 2)
            assert len(bf16) == n_bf16 and all(w == torch.bfloat16 for _, w, _ in bf16)
            assert all(rounded for _, _, rounded in products.calls)
            # and the two node halves of each factored first layer, in f32
            assert len(products.calls) == n_bf16 + 2 * EDM_TINY["n_layers"] * (
                EDM_TINY["inv_sublayers"] + 1)
        else:
            assert not bf16 and not all(rounded for _, _, rounded in products.calls)
