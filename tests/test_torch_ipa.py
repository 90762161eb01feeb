"""reed_tpu_torch's MultiFlow network (models/ipa.py) against reed_tpu's on
the CPU, f32: the embeddings, InvariantPointAttention alone, the feature
nets and the whole FlowModel at c_s 32, c_z 16, 2 blocks, 12 residues with
padded rows, every weight (the zero-initialised ones too) drawn from a
seeded normal on reed_tpu's side and carried over by state_dict_from_flax;
outputs to 1e-5 of their max. Then the layout: reed_tpu's converter reads
the port's state_dict back to the flax params bitwise, and the port loads
the reference-structured torch mini TFlowModel strictly and matches it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders.multiflow_convert import convert_torch_multiflow
from reed_tpu.models import ipa as jipa
from reed_tpu_torch.encoders.multiflow_convert import (load_reference_checkpoint,
                                                       state_dict_from_flax, strip_state_dict,
                                                       widths)
from reed_tpu_torch.models import ipa
from test_multiflow_convert import TFlowModel

torch.set_num_threads(1)
TOL = 1e-5
KW = dict(c_s=32, c_z=16, num_blocks=2, ipa_c_hidden=8, ipa_no_heads=2, ipa_no_qk_points=3,
          ipa_no_v_points=4, seq_tfmr_num_heads=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.standard_normal((int(np.prod(shape)), 3, 3)))
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q.reshape(tuple(shape) + (3, 3)).astype(np.float32)


def flow_batch(b=2, n=12, seed=0):
    """A noisy batch with a padded row at the end of the last chain."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[-1, -2:] = 0.0
    t = rng.uniform(0.1, 0.9, (b, 1)).astype(np.float32)
    return {"res_mask": mask, "so3_t": t, "r3_t": t, "cat_t": t,
            "trans_t": (rng.standard_normal((b, n, 3)) * 6).astype(np.float32) * mask[..., None],
            "rotmats_t": _rotations(rng, (b, n)),
            "aatypes_t": rng.integers(0, 21, (b, n)).astype(np.int32),
            "aatypes_sc": rng.standard_normal((b, n, 21)).astype(np.float32),
            "trans_sc": (rng.standard_normal((b, n, 3)) * 4).astype(np.float32),
            "res_idx": np.tile(np.arange(n), (b, 1)).astype(np.int32)}


def to_torch(batch):
    ints = ("aatypes_t", "res_idx", "aatypes_1")
    return {k: _t(v).long() if k in ints else _t(v) for k, v in batch.items()}


def seeded_params(params, seed=1, scale=0.3, bb_scale=0.05):
    """Every leaf from a seeded normal; the backbone updates scaled small, so
    that the composed rigid updates stay well-conditioned."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(seed)
    out = []
    for path, leaf in leaves:
        s = bb_scale if "bb_update" in jax.tree_util.keystr(path) else scale
        out.append((rng.standard_normal(np.shape(leaf)) * s).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def models(seed=1, dtype="float32"):
    """(reed_tpu FlowModel, its seeded params, the port's FlowModel holding
    them)."""
    jmodel = jipa.FlowModel(**KW, dtype=jnp.dtype(dtype))
    batch = {k: jnp.asarray(v) for k, v in flow_batch().items()}
    params = seeded_params(jmodel.init(jax.random.PRNGKey(0), batch)["params"], seed)
    model = ipa.FlowModel(**KW, compute_dtype=getattr(torch, dtype))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmodel, params, model


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def test_embeddings_match_jax():
    # the sine arguments reach t * 2056 ~ 2e3, where one f32 ulp is 1.2e-4
    t = np.array([0.01, 0.37, 0.99], np.float32)
    np.testing.assert_allclose(ipa.mf_time_embedding(_t(t), 128).numpy(),
                               np.asarray(jipa.mf_time_embedding(jnp.asarray(t), 128)),
                               atol=1.2e-4)
    idx = np.arange(-20, 20).reshape(4, 10)
    np.testing.assert_allclose(ipa.mf_index_embedding(_t(idx), 64).numpy(),
                               np.asarray(jipa.mf_index_embedding(jnp.asarray(idx), 64)),
                               atol=2e-5)
    pos = (np.random.default_rng(0).standard_normal((2, 9, 3)) * 8).astype(np.float32)
    assert np.array_equal(ipa.mf_distogram(_t(pos)).numpy(),
                          np.asarray(jipa.mf_distogram(jnp.asarray(pos))))


def test_invariant_point_attention_matches_jax():
    rng = np.random.default_rng(1)
    b, n = 2, 7
    s = rng.standard_normal((b, n, 32)).astype(np.float32)
    z = rng.standard_normal((b, n, n, 16)).astype(np.float32)
    trans = rng.standard_normal((b, n, 3)).astype(np.float32)
    rot = _rotations(rng, (b, n))
    mask = np.ones((b, n), np.float32)
    mask[1, -2:] = 0.0
    jm = jipa.InvariantPointAttention(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=3,
                                      no_v_points=4)
    args = [jnp.asarray(a) for a in (s, z, rot, trans, mask)]
    params = seeded_params(jm.init(jax.random.PRNGKey(0), *args)["params"], seed=2)
    want = jm.apply({"params": params}, *args)
    sd = {k[len("trunk.ipa_0."):]: v for k, v in state_dict_from_flax(
        {"ipa_0": params, **_stub_params()}).items() if k.startswith("trunk.ipa_0.")}
    m = ipa.InvariantPointAttention(32, 16, 8, 2, 3, 4)
    m.load_state_dict(sd, strict=True)
    got = m(*(_t(a) for a in (s, z, rot, trans, mask)))
    assert rel_err(got, want) <= TOL


def _stub_params():
    """The entries state_dict_from_flax needs besides one IPA, from a tiny
    reed_tpu FlowModel of one block."""
    jm = jipa.FlowModel(**{**KW, "num_blocks": 1})
    batch = {k: jnp.asarray(v) for k, v in flow_batch().items()}
    params = dict(jm.init(jax.random.PRNGKey(0), batch)["params"])
    del params["ipa_0"]
    return params


def test_feature_nets_match_jax():
    jmodel, params, model = models(seed=3)
    batch = flow_batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = to_torch(batch)
    mask = jb["res_mask"]
    args = (jb["so3_t"], jb["r3_t"], jb["cat_t"], mask, jnp.ones_like(mask), jb["res_idx"],
            jb["aatypes_t"], jb["aatypes_sc"])
    jnode = jipa.NodeFeatureNet(32).apply({"params": params["node_feature_net"]}, *args)
    node = model.node_feature_net(tb["so3_t"], tb["r3_t"], tb["cat_t"], tb["res_mask"],
                                  torch.ones_like(tb["res_mask"]), tb["res_idx"],
                                  tb["aatypes_t"], tb["aatypes_sc"])
    assert rel_err(node, jnode) <= TOL
    edge_mask = mask[:, None, :] * mask[:, :, None]
    jedge = jipa.EdgeFeatureNet(32, 16).apply(
        {"params": params["edge_feature_net"]}, jnode, jb["trans_t"], jb["trans_sc"],
        edge_mask, jnp.ones_like(mask))
    edge = model.edge_feature_net(_t(jnode), tb["trans_t"], tb["trans_sc"], _t(edge_mask),
                                  torch.ones_like(tb["res_mask"]))
    assert rel_err(edge, jedge) <= TOL


@pytest.mark.parametrize("seed", [1, 4])
def test_flow_model_matches_jax(seed):
    jmodel, params, model = models(seed)
    batch = flow_batch(seed=seed)
    want = jmodel.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model(to_torch(batch))
    for k in ("pred_trans", "pred_rotmats", "pred_logits"):
        assert got[k].dtype == torch.float32
        assert rel_err(got[k], want[k]) <= TOL, (k, rel_err(got[k], want[k]))


def test_state_dict_is_the_reference_layout():
    """reed_tpu's converter of reference checkpoints reads the port's
    state_dict back to the flax params bitwise (so the port's names and
    point-column layouts are the reference's), and the widths are read
    off it."""
    _, params, model = models(seed=5)
    back = convert_torch_multiflow({k: v.numpy() for k, v in model.state_dict().items()})
    want = dict((jax.tree_util.keystr(p), v)
                for p, v in jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict((jax.tree_util.keystr(p), v)
               for p, v in jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert widths(model.state_dict()) == {
        "c_s": 32, "c_z": 16, "num_blocks": 2, "seq_tfmr_num_layers": 2, "ipa_c_hidden": 8,
        "ipa_no_heads": 2, "ipa_no_qk_points": 3, "ipa_no_v_points": 4}


def _tflow(seed=0):
    torch.manual_seed(seed)
    tmodel = TFlowModel().eval()
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            if "linear_out" in name or "post_tfmr" in name:
                p.normal_(std=0.2)
            elif "bb_update" in name:
                p.normal_(std=0.02)
    return tmodel


def test_loads_reference_torch_model_strictly(tmp_path):
    """The reference-structured torch mini (tests/test_multiflow_convert.py)
    loads with strict=True, directly and from a Lightning-style file, and
    the port matches its outputs to 1e-5 of their max."""
    tmodel = _tflow()
    model = ipa.FlowModel(**KW)
    model.load_state_dict(tmodel.state_dict(), strict=True)
    path = str(tmp_path / "last.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in tmodel.state_dict().items()},
                "epoch": 3}, path)
    sd, dims = load_reference_checkpoint(path)
    assert dims == widths(strip_state_dict(tmodel.state_dict()))
    assert dims["num_blocks"] == 2 and dims["ipa_no_v_points"] == 4
    model.load_state_dict(sd, strict=True)
    batch = flow_batch(seed=6)
    batch["res_mask"][:] = 1.0  # the mini masks keys with -inf: full rows only
    tb = to_torch(batch)
    tb["diffuse_mask"] = torch.ones_like(tb["res_mask"])
    tfeats = dict(tb, so3_t=tb["so3_t"][:, 0], r3_t=tb["r3_t"][:, 0], cat_t=tb["cat_t"][:, 0])
    with torch.no_grad():
        want = tmodel(tfeats)
        got = model(tb)
    for k in want:
        err = ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
        assert err <= TOL, (k, err)
