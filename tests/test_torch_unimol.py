"""reed_tpu_torch's UniMol global encoder against reed_tpu's on the CPU:
the rep of a small UniMolGlobal (vocab 16, width 32, 3 layers, 4 heads,
K 8) with the same seeded-normal weights (carried by
unimol_convert.state_dict_from_flax) on ragged token batches, to 1e-5 of
its max; the reference-layout torch state dict that
tests/test_unimol_convert.py builds, loaded into the port through
convert_torch_unimol, against reed_tpu's rep of the same weights; the
standardisation, the unmasked pooling, rigid-motion invariance and
format_input_to_unimol against reed_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders import unimol as junimol
from reed_tpu.encoders.unimol_convert import convert_torch_unimol as jax_convert
from reed_tpu_torch.encoders import unimol, unimol_convert
from test_unimol_convert import D, FFN, HEADS, K, LAYERS, PAD, VOCAB, TUniMolGlobal

torch.set_num_threads(1)
RTOL = 1e-5
SMALL = dict(vocab_size=VOCAB, embed_dim=D, ffn_dim=FFN, heads=HEADS, layers=LAYERS,
             gaussian_k=K, rep_dim=D, padding_idx=PAD)


def _inputs(seed=0, b=3, n=8):
    """BOS ... EOS token rows, the last rows padded (0), their distances and
    edge types (type_i * VOCAB + type_j)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, VOCAB, (b, n)).astype(np.int64)
    tokens[:, 0] = 1
    sizes = [n, n - 2, n - 3][:b]
    for i, k in enumerate(sizes):
        tokens[i, k - 1] = 2
        tokens[i, k:] = PAD
    coords = rng.standard_normal((b, n, 3)).astype(np.float32) * 1.5
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1).astype(np.float32)
    edge_type = tokens[:, :, None] * VOCAB + tokens[:, None, :]
    return tokens, dist, edge_type


def _random_params(model, inputs, std=0.1, seed=0):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *(jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
                                 for x in inputs)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = (rng.standard_normal(s.shape) * std).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or "['mul']" in key:
            return x + 1.0
        if "['means']" in key or "['stds']" in key:
            return np.abs(x) * 10 + 0.5
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_rep(model, params, inputs):
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, params),
                                  *(jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
                                    for x in inputs)))


def _port_rep(model, inputs):
    with torch.no_grad():
        return model(*(torch.tensor(x) for x in inputs)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_rep_matches_jax(seed):
    inputs = _inputs(seed)
    jmodel = junimol.UniMolGlobal(**SMALL)
    params = _random_params(jmodel, inputs, seed=seed)
    ref = _jax_rep(jmodel, params, inputs)
    model = unimol.UniMolGlobal(**SMALL).eval()
    model.load_state_dict(unimol_convert.state_dict_from_flax(params))
    out = _port_rep(model, inputs)
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()
    # standardised by the unbiased std
    np.testing.assert_allclose(out.mean(-1), 0, atol=1e-5)
    np.testing.assert_allclose(out.std(-1, ddof=1), 1, atol=1e-4)


def test_reference_state_dict_gives_reed_tpus_rep():
    """tests/test_unimol_convert.py's reference-layout torch model: its state
    dict through the port's loader and through reed_tpu's converter gives the
    same rep."""
    torch.manual_seed(0)
    tmodel = TUniMolGlobal().eval()
    sd = {f"model.{k}": v for k, v in tmodel.state_dict().items()}
    sd["model.lm_head.dense.weight"] = torch.zeros(3, 3)  # a training-only head
    inputs = _inputs(3)
    jmodel = junimol.UniMolGlobal(**SMALL)
    ref = _jax_rep(jmodel, {"params": jax_convert(
        {k[6:]: v for k, v in sd.items() if "lm_head" not in k})}, inputs)
    port_sd = unimol_convert.convert_torch_unimol(sd, prefix="model.")
    assert unimol_convert.widths(port_sd) == {k: v for k, v in SMALL.items()
                                             if k != "padding_idx"}
    model = unimol_convert.unimol_from_state_dict(port_sd)
    out = _port_rep(model, inputs)
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()


def test_checkpoint_file_and_shape_check(tmp_path):
    torch.manual_seed(1)
    sd = TUniMolGlobal().state_dict()
    path = str(tmp_path / "unimol.pt")
    torch.save({"model": sd}, path)
    loaded = unimol_convert.load_torch_unimol_checkpoint(path)
    assert set(loaded) == set(sd)
    bad = dict(sd)
    bad["encoder.layers.1.fc1.weight"] = torch.zeros(FFN + 1, D)
    with pytest.raises(ValueError, match="shapes"):
        unimol_convert.convert_torch_unimol(bad)
    del bad["encoder.layers.1.fc1.weight"]
    with pytest.raises(ValueError, match="lacks"):
        unimol_convert.convert_torch_unimol(bad)


def test_pooling_is_unmasked():
    """The padded positions enter the mean: moving a padded position's
    distances changes nothing (its key is masked), but the pooled rep still
    carries its evolved features, so it differs from a masked mean."""
    model = unimol.UniMolGlobal(**SMALL).initialize_weights(torch.Generator().manual_seed(0))
    tokens, dist, et = (torch.tensor(x) for x in _inputs(0))
    pad = tokens == PAD
    with torch.no_grad():
        out = model(tokens, dist, et)
        dist2 = dist.clone()
        dist2[1, :, -1] += 3.0
        dist2[1, -1, :] += 3.0
        out2 = model(tokens, dist2, et)
    assert pad[1].any()
    # row 1's real tokens do not see its padded key, but its pooled mean
    # takes the padded row itself, whose bias row moved
    assert not torch.allclose(out[1], out2[1], atol=1e-6)
    torch.testing.assert_close(out[0], out2[0])


def test_rigid_motion_invariance():
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((1, 5, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    moved = coords @ q.T + 5.0
    tokens = np.full((1, 5), 4)
    tokens[:, 0], tokens[:, -1] = 1, 2
    et = tokens[:, :, None] * VOCAB + tokens[:, None, :]
    model = unimol.UniMolGlobal(**SMALL).initialize_weights(torch.Generator().manual_seed(0))

    def rep(c):
        d = np.linalg.norm(c[:, :, None] - c[:, None], axis=-1).astype(np.float32)
        return _port_rep(model, (tokens, d, et))

    np.testing.assert_allclose(rep(coords), rep(moved), atol=1e-4)


def test_format_input_matches_jax():
    rng = np.random.default_rng(2)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    types = rng.integers(0, 16, (2, 5))
    coords = rng.standard_normal((2, 5, 3)).astype(np.float32)
    ref = junimol.format_input_to_unimol(types, coords, mask)
    out = unimol.format_input_to_unimol(types, coords, mask)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(out[0][0]) == [1, types[0, 0] + 3, types[0, 1] + 3, types[0, 2] + 3, 2, 0, 0]
