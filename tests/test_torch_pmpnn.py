"""reed_tpu_torch's ProteinMPNN-FMIF, graph ops and weight conversion against
reed_tpu's, same weights and inputs, f32 on the CPU. Every weight,
node_embeds and LayerNorms included, is a seeded random draw."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders.fmif_convert import convert_torch_fmif
from reed_tpu.ops import graph as jg
from reed_tpu_torch.encoders.fmif_convert import (load_reference_checkpoint,
                                                  state_dict_from_flax)
from reed_tpu_torch.models.pmpnn import (MASK_TOKEN_INDEX, ProteinMPNNFMIF,
                                         create_pmpnn)
from reed_tpu_torch.ops import graph as tg
from torch_parity import FMIF_TINY, fmif_args, fmif_batch, tiny_fmif_pair

torch.set_num_threads(1)

ATOL = 2e-4  # as tests/test_fused_message.py; measured errors are ~1e-6


def _port(model, batch, s=None, **kw):
    args = [torch.tensor(a) for a in fmif_args(batch, s)]
    if "cls" in kw:
        kw["cls"] = torch.tensor(kw["cls"])
    with torch.no_grad():
        out = model(*args, **kw)
    return out


def _jax(jax_model, variables, batch, s=None, **kw):
    return jax_model.apply(variables, *fmif_args(batch, s), **kw)


def test_knn_graph_and_rbf_match_jax():
    """Valid rows only: padded rows are all ties, which torch.topk and
    lax.top_k need not order alike."""
    batch = fmif_batch(batch=2, length=16, pad=5)
    ca, mask = batch["X"][:, :, 1], batch["mask"]
    d_ref, idx_ref = jg.knn_graph(jnp.asarray(ca), jnp.asarray(mask), 6)
    d, idx = tg.knn_graph(torch.tensor(ca), torch.tensor(mask), 6)
    assert idx.dtype == torch.int32 and idx.shape == (2, 16, 6)
    valid = mask.astype(bool)
    np.testing.assert_array_equal(idx.numpy()[valid], np.asarray(idx_ref)[valid])
    np.testing.assert_allclose(d.numpy()[valid], np.asarray(d_ref)[valid],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.rbf(d).numpy(), np.asarray(jg.rbf(d_ref)),
                               rtol=1e-5, atol=1e-6)
    # k is cut to N
    assert tg.knn_graph(torch.tensor(ca), torch.tensor(mask), 40)[1].shape[-1] == 16


def test_gathers_match_jax():
    rng = np.random.default_rng(0)
    nodes = rng.standard_normal((2, 7, 5)).astype(np.float32)
    edges = rng.standard_normal((2, 7, 7, 3)).astype(np.float32)
    idx = rng.integers(0, 7, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tg.gather_nodes(torch.tensor(nodes), torch.tensor(idx)).numpy(),
        np.asarray(jg.gather_nodes(nodes, idx)))
    np.testing.assert_array_equal(
        tg.gather_edges(torch.tensor(edges), torch.tensor(idx)).numpy(),
        np.asarray(jg.gather_edges(edges, idx)))


@pytest.mark.parametrize("use_cfg", [False, True])
def test_state_dict_round_trip(use_cfg):
    batch = fmif_batch()
    cls = np.array([0, 2], np.int32) if use_cfg else None
    _, variables, model = tiny_fmif_pair(batch, cls=cls, use_cfg=use_cfg)
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(model.state_dict())
    back = convert_torch_fmif(sd)
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    """The same switch on both sides: reed_tpu's fused chain runs its Pallas
    kernel in interpret mode, the port's its plain version."""
    batch = fmif_batch()
    jax_model, variables, model = tiny_fmif_pair(batch, fused=fused)
    assert np.abs(variables["params"]["node_embeds"]).max() > 0.05
    ref = _jax(jax_model, variables, batch)
    out = _port(model, batch)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ATOL, atol=ATOL)


def _tokens(batch, seed=3, masked=0.5):
    """Tokens with a share of them masked, as a sampler step sees them."""
    rng = np.random.default_rng(seed)
    s = batch["S"].copy()
    s[rng.random(s.shape) < masked] = MASK_TOKEN_INDEX
    return s


# (name, model overrides, call kwargs); reed_tpu runs unfused, the port both
CASES = [
    ("return_rep", {}, dict(return_rep=True)),
    ("mdlm", dict(mdlm_parameterization=True), {}),
    ("soft_onehot", {}, dict(soft=True)),
    ("cfg_cls", dict(use_cfg=True), dict(cls=np.array([1, 2], np.int32))),
    ("padded", {}, dict(pad=4)),
]


@pytest.mark.parametrize("name,overrides,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("fused", [False, True])
def test_forward_variants_match_jax(name, overrides, kw, fused):
    kw = dict(kw)
    batch = fmif_batch(length=16, pad=kw.pop("pad", 0))
    s = _tokens(batch)
    if kw.pop("soft", False):
        s = np.eye(22, dtype=np.float32)[s] * 0.7 + 0.3 / 22
    jax_model, variables, model = tiny_fmif_pair(batch, cls=kw.get("cls"), **overrides)
    model.fused = fused
    ref = _jax(jax_model, variables, batch, s=s, **kw)
    out = _port(model, batch, s=s, **kw)
    valid = batch["mask"].astype(bool)
    if kw.get("return_rep"):
        for r, o in zip(ref[:4], out[:4]):
            np.testing.assert_allclose(o.numpy()[valid], np.asarray(r)[valid],
                                       rtol=ATOL, atol=ATOL)
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
        return
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_hoisting_matches_jax(fused):
    """return_enc once, then enc_state per step: the same log-probs as a
    full call, and as reed_tpu's own hoisting."""
    batch = fmif_batch()
    jax_model, variables, model = tiny_fmif_pair(batch, fused=fused)
    h_v, h_e, e_idx, _ = _jax(jax_model, variables, batch, return_enc=True)
    enc = _port(model, batch, return_enc=True)
    assert len(enc) == 3 and enc[2].dtype == torch.int32
    np.testing.assert_allclose(enc[0].numpy(), np.asarray(h_v), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(enc[1].numpy(), np.asarray(h_e), rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(enc[2].numpy(), np.asarray(e_idx))
    s = _tokens(batch, seed=4)
    full = _port(model, batch, s=s)
    hoisted = _port(model, batch, s=s, enc_state=enc)
    torch.testing.assert_close(hoisted, full, rtol=0, atol=0)
    ref = _jax(jax_model, variables, batch, s=s)
    np.testing.assert_allclose(hoisted.numpy(), np.asarray(ref), rtol=ATOL, atol=ATOL)


def test_fused_and_unfused_chains_agree_in_port():
    batch = fmif_batch(pad=3)
    _, _, model = tiny_fmif_pair(batch)
    model.fused = False
    a = _port(model, batch, return_rep=True)
    model.fused = True
    b = _port(model, batch, return_rep=True)
    for x, y in zip(a[:4], b[:4]):
        torch.testing.assert_close(x, y, rtol=ATOL, atol=ATOL)


def test_bf16_keeps_f32_layernorms_projectors_and_log_probs():
    batch = fmif_batch()
    _, _, model = tiny_fmif_pair(batch)
    ref = _port(model, batch, return_rep=True)
    model.to_compute_dtype(torch.bfloat16)
    assert model.dtype == torch.bfloat16
    assert model.encoder_layers[0].norm1.weight.dtype == torch.float32
    assert model.projectors_pair[0].weight.dtype == torch.float32
    out = _port(model, batch, return_rep=True)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.float32
    assert torch.isfinite(out[0]).all()
    # bf16 rounding of weights and activations through 2 + 2 layers
    assert (out[0] - ref[0]).abs().max() < 0.1


def test_initialisation_is_reed_tpus_and_seeded():
    a = create_pmpnn(generator=torch.Generator().manual_seed(0), **FMIF_TINY)
    b = create_pmpnn(generator=torch.Generator().manual_seed(0), **FMIF_TINY)
    c = create_pmpnn(generator=torch.Generator().manual_seed(1), **FMIF_TINY)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.W_e.weight, c.W_e.weight)
    assert torch.count_nonzero(a.node_embeds) == 0
    assert torch.equal(a.decoder_layers[0].norm1.weight, torch.ones(32))
    w = a.encoder_layers[0].W1.weight  # xavier-uniform over [32, 96]
    assert w.abs().max() <= (6 / (32 + 96)) ** 0.5 and w.std() > 0.1
    assert 0.01 < a.W_s.weight.std() < 0.03


def test_load_reference_checkpoint(tmp_path):
    """A reference-layout .pt ({'model_state_dict': ...} with the DDP
    'module.' prefix and the tied W_s_ft) loads into the port's model."""
    model = ProteinMPNNFMIF(**FMIF_TINY)
    sd = {k: torch.randn(v.shape) for k, v in model.state_dict().items()}
    ckpt = {"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}
    ckpt["model_state_dict"]["module.W_s_ft.weight"] = sd["W_s.weight"].clone()
    torch.save(ckpt, tmp_path / "epoch_last.pt")
    loaded = load_reference_checkpoint(str(tmp_path / "epoch_last.pt"))
    assert set(loaded) == set(sd)
    model.load_state_dict(loaded)
    # and reed_tpu's converter reads the same names
    assert set(convert_torch_fmif(loaded)) >= {"features", "W_e", "W_s_embedding"}


# fused_messages by width: the kernels take D % 16 == 0, D <= 128, and the
# decoder's edge width is 2 x hidden
@pytest.mark.parametrize("hidden,k,fused", [(128, 30, True), (32, 4, True), (100, 30, False),
                                            (256, 30, False), (128, 65, False)])
def test_auto_resolves_by_the_widths_the_kernels_take(hidden, k, fused):
    from reed_tpu_torch.train.protein import ProteinTrainConfig, resolve_fused

    cfg = ProteinTrainConfig(hidden_dim=hidden, k_neighbors=k)
    assert resolve_fused(cfg) is fused
    assert resolve_fused(dataclasses.replace(cfg, fused_messages="off")) is False
    if fused:
        assert resolve_fused(dataclasses.replace(cfg, fused_messages="on")) is True
    else:
        with pytest.raises(ValueError, match="fused message kernel"):
            resolve_fused(dataclasses.replace(cfg, fused_messages="on"))


def test_auto_at_hidden_100_builds_unfused_and_matches_jax():
    """hidden 100 is no multiple of 16: 'auto' builds the unfused chain (as
    reed_tpu's 'auto' does), whose CPU forward matches reed_tpu's; 'on'
    refuses the width at build time."""
    from reed_tpu_torch.encoders.fmif_convert import state_dict_from_flax as to_torch
    from reed_tpu_torch.train.protein import ProteinTrainConfig, build_model

    widths = dict(FMIF_TINY, hidden_dim=100, edge_features=100)
    batch = fmif_batch()
    jax_model, variables, _ = tiny_fmif_pair(batch, **widths)
    cfg = ProteinTrainConfig(**{k: v for k, v in widths.items() if k != "edge_features"})
    model = build_model(cfg, device="cpu")
    assert model.fused is False
    model.load_state_dict(to_torch(variables))
    np.testing.assert_allclose(_port(model, batch).numpy(),
                               np.asarray(_jax(jax_model, variables, batch)),
                               rtol=ATOL, atol=ATOL)
    with pytest.raises(ValueError, match="D = 100"):
        build_model(dataclasses.replace(cfg, fused_messages="on"), device="cpu")
