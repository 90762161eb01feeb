"""reed_tpu_torch's SemlaGenerator against reed_tpu's on the CPU: a tiny
model (d_model 32, 3 layers, 4 coordinate sets, batch 3 x 10 atoms with
padded rows) with the same seeded-normal weights, in every configuration
the port runs: with and without edges, self-conditioning on and off, rep
conditioning none / adaLN / cross_attn, REPA projectors, the residual
coordinate head. Every output and every projection `zs` must agree to
1e-5 of its max; padded atoms' coordinates are exactly 0 in both. Then
the E(3) equivariance of the port's coordinates and the factored
coordinate attention against the direct difference form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu_torch.models import semla
from torch_parity import SEMLA_TINY, semla_inputs, semla_pair

torch.set_num_threads(1)
RTOL = 1e-5

CONFIGS = {
    "default": {},
    "no_edges": dict(d_edge=None),
    "no_self_cond": dict(self_cond=False),
    "adaLN": dict(cond_type="adaLN"),
    "cross_attn": dict(cond_type="cross_attn"),
    "coord_skip": dict(coord_skip=True),
    "no_alignment": dict(rep_alignment=False, d_rep=None),
    "gvp_two_projectors": dict(coord_norm="gvp", align_depth=(0, 2), n_attn_heads=None),
}


def _run_both(jax_model, params, model, inputs):
    jout = jax_model.apply({"params": jax.tree.map(jnp.asarray, params)},
                           **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        tout = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    return jout, tout


def _close(name, ours, ref):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(ours - ref).max()
    assert np.isfinite(ours).all() and err <= RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reed_tpu(name):
    jax_model, params, model, inputs = semla_pair(**CONFIGS[name])
    jout, tout = _run_both(jax_model, params, model, inputs)
    for label, ours, ref in zip(("coords", "type_logits", "bond_logits",
                                 "charge_logits"), tout[:4], jout[:4]):
        if ref is None:
            assert ours is None, label
            continue
        _close(label, ours, ref)
    assert len(tout[4]) == len(jout[4])
    for i, (ours, ref) in enumerate(zip(tout[4], jout[4])):
        _close(f"zs[{i}]", ours, ref)
    if model.dynamics.projectors:
        assert tout[4], "alignment on, no zs"
    pad = inputs["atom_mask"] == 0
    assert pad.any()
    assert (tout[0].numpy()[pad] == 0).all() and (np.asarray(jout[0])[pad] == 0).all()


def test_equivariance():
    """Rotating and translating the input coordinates (and the
    self-conditioning coordinates) rotates the predicted coordinates (zero
    CoM, so the translation drops out) and leaves every logit unchanged."""
    kw = dict(SEMLA_TINY, cond_type="adaLN")
    _, _, model, inputs = semla_pair(**kw)
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    theta = 0.7
    rot = torch.tensor([[np.cos(theta), -np.sin(theta), 0.0],
                        [np.sin(theta), np.cos(theta), 0.0], [0.0, 0.0, 1.0]])
    rot = rot @ torch.tensor([[1.0, 0, 0], [0, np.cos(1.1), -np.sin(1.1)],
                              [0, np.sin(1.1), np.cos(1.1)]])
    rot = rot.float()
    shift = torch.tensor([0.3, -1.2, 2.0])
    mask = x["atom_mask"][..., None]
    moved = dict(x)
    for k in ("coords", "cond_coords"):
        moved[k] = (x[k] @ rot.T + shift) * mask
    with torch.no_grad():
        out, out_moved = model(**x), model(**moved)
    np.testing.assert_allclose(out_moved[0].numpy(), (out[0] @ rot.T).numpy(), atol=2e-4)
    for a, b in zip(out[1:4], out_moved[1:4]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4)


def test_coord_attention_factored_matches_direct():
    """The factored update (gram identity, zeroed diagonal) against the
    direct sum over difference vectors, padded atoms at zero."""
    rng = np.random.default_rng(0)
    b, n, p, eps = 2, 7, 3, 1e-6
    proj = torch.from_numpy(rng.standard_normal((b, n, 3, p)).astype(np.float32))
    proj[:, -2:] = 0.0
    attn = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, n, n, p)).astype(np.float32)), dim=2)
    vec = proj[:, :, None] - proj[:, None, :]                     # [B,i,j,3,P]
    lengths = semla.safe_norm(vec, dim=3, keepdim=True)
    direct = torch.einsum("bijdp,bijp->bidp", vec / (lengths + eps), attn)
    factored = semla._coord_attention_updates(proj, attn, eps)
    np.testing.assert_allclose(factored.numpy(), direct.numpy(), rtol=2e-4, atol=2e-5)


def test_all_padding_row_stays_finite():
    """A batch row whose atoms are all padded keeps finite outputs (the
    attention masks give such rows an all-zero row, as reed_tpu's)."""
    kw = dict(SEMLA_TINY)
    inputs = semla_inputs(kw)
    inputs["atom_mask"][1] = 0.0
    _, _, model, _ = semla_pair(inputs=inputs)
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for t in out[:4]:
        assert torch.isfinite(t).all()
    assert (out[0][1] == 0).all()


@pytest.mark.parametrize("cond_type", ["none", "adaLN"])
def test_mixed_precision_keeps_coordinates_f32(cond_type):
    """compute_dtype bfloat16: the feature and message path is bf16 and
    every coordinate-valued tensor f32 (CoordAttention's update,
    NodeFeedForward's coordinate half, the coordinate head), as are the
    rep conditioning, the projectors, the returned coordinates and logits,
    the parameters and their gradients; f32 compute leaves it all f32."""
    kw = dict(SEMLA_TINY, cond_type=cond_type)
    inputs = {k: torch.from_numpy(v) for k, v in semla_inputs(kw).items()}
    for dtype in (torch.bfloat16, torch.float32):
        model = semla.SemlaGenerator(**kw, compute_dtype=dtype).initialize_weights(
            torch.Generator().manual_seed(0))
        seen = {}

        def hook(name):
            def record(module, args, out):
                seen.setdefault(name, set()).update(
                    t.dtype for t in (out if isinstance(out, tuple) else (out,))
                    if isinstance(t, torch.Tensor))
            return record

        for name, cls in (("coord_attn", semla.CoordAttention),
                          ("messages", semla.EdgeMessages),
                          ("node_attn", semla.NodeAttention),
                          ("rep_cond", semla.RepConditioner)):
            for m in model.modules():
                if isinstance(m, cls):
                    m.register_forward_hook(hook(name))
        def ff_hook(module, args, out):
            seen.setdefault("ff_coords", set()).add(out[0].dtype)
            seen.setdefault("ff_nodes", set()).add(out[1].dtype)

        for m in model.modules():
            if isinstance(m, semla.NodeFeedForward):
                m.register_forward_hook(ff_hook)
        model.dynamics.coord_head.register_forward_hook(hook("coord_head"))
        coords, types, bonds, charges, zs = model(**inputs)
        low = {dtype}
        assert seen["coord_attn"] == seen["ff_coords"] == seen["coord_head"] == {torch.float32}
        assert seen["messages"] == seen["node_attn"] == seen["ff_nodes"] == low
        if cond_type != "none":
            assert seen["rep_cond"] == {torch.float32}
        assert all(t.dtype == torch.float32 for t in (coords, types, bonds, charges, *zs))
        loss = coords.square().sum() + types.sum() + sum(z.sum() for z in zs)
        loss.backward()
        assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype ==
                                                 torch.float32) for p in model.parameters())
        assert torch.isfinite(coords).all() and torch.isfinite(types).all()
