"""reed_tpu_torch's TorchMD-ET (Frad) encoder against reed_tpu's on the
CPU: TorchMDET (hidden 32, 2 layers, 16 RBFs, 4 heads) and FradEncoder with
the same seeded-normal weights (carried by torchmd_et.state_dict_from_flax)
on ragged batches, scalar and vector features to 1e-5 of their max; the
reference-layout torch state dict that tests/test_torchmd_et.py builds
('representation_model.' prefixes, in a checkpoint file), loaded into the
port, against reed_tpu's converted forward; invariance, equivariance and
the masking of padded atoms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.encoders import torchmd_et as jet
from reed_tpu_torch.encoders import torchmd_et as tet

torch.set_num_threads(1)
RTOL = 1e-5
SMALL = dict(hidden=32, num_layers=2, num_rbf=16, num_heads=4, max_z=20)


def _inputs(seed=0, b=3, n=7):
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 20, (b, n))
    pos = (rng.standard_normal((b, n, 3)) * 1.6).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[1, 5:] = 0
    mask[2, 4:] = 0
    return z, pos, mask


def _random_params(model, inputs, std=0.1, seed=0):
    z, pos, mask = inputs
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(z),
                                               jnp.asarray(pos), jnp.asarray(mask)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = (rng.standard_normal(s.shape) * std).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return x + 1.0
        if "['means']" in key:
            return np.linspace(0.01, 1.0, s.shape[0]).astype(np.float32) + x * 0.1
        if "['betas']" in key:
            return np.abs(x) * 50 + 5.0
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(a, b, name):
    b = np.asarray(b)
    assert np.abs(a - b).max() <= RTOL * np.abs(b).max(), (name, np.abs(a - b).max())


@pytest.mark.parametrize("neighbor", [True, False])
def test_et_matches_jax(neighbor):
    inputs = _inputs()
    jmodel = jet.TorchMDET(**SMALL, neighbor_embedding=neighbor)
    params = _random_params(jmodel, inputs)
    jx, jvec = jmodel.apply(jax.tree.map(jnp.asarray, params),
                            *(jnp.asarray(x) for x in inputs))
    model = tet.TorchMDET(**SMALL, neighbor_embedding=neighbor).eval()
    model.load_state_dict(tet.state_dict_from_flax(params))
    with torch.no_grad():
        x, vec = model(*(torch.tensor(a) for a in inputs))
    _close(x.numpy(), jx, "x")
    _close(vec.numpy(), jvec, "vec")


def test_frad_rep_matches_jax():
    inputs = _inputs(1)
    jmodel = jet.FradEncoder(et=jet.TorchMDET(**SMALL))
    params = _random_params(jmodel, inputs, seed=1)
    ref = jmodel.apply(jax.tree.map(jnp.asarray, params), *(jnp.asarray(x) for x in inputs))
    model = tet.frad_from_state_dict(tet.state_dict_from_flax(params), num_heads=4)
    with torch.no_grad():
        out = model(*(torch.tensor(a) for a in inputs))
    _close(out.numpy(), ref, "rep")


def test_reference_checkpoint_gives_reed_tpus_forward(tmp_path):
    """The reference-layout state dict of tests/test_torchmd_et.py, saved
    under 'representation_model.' in a checkpoint file: the port's loader
    and reed_tpu's converter give the same forward."""
    hidden, r, layers, max_z = 32, 16, 2, 20
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"embedding.weight": t(max_z, hidden),
          "distance_expansion.means": torch.linspace(0.01, 1.0, r),
          "distance_expansion.betas": torch.abs(t(r)) * 100 + 10.0,
          "out_norm.weight": 1 + t(hidden), "out_norm.bias": t(hidden),
          "neighbor_embedding.embedding.weight": t(max_z, hidden),
          "neighbor_embedding.distance_proj.weight": t(hidden, r),
          "neighbor_embedding.distance_proj.bias": t(hidden),
          "neighbor_embedding.combine.weight": t(hidden, 2 * hidden),
          "neighbor_embedding.combine.bias": t(hidden)}
    for i in range(layers):
        p = f"attention_layers.{i}"
        sd.update({f"{p}.layernorm.weight": 1 + t(hidden), f"{p}.layernorm.bias": t(hidden),
                   f"{p}.q_proj.weight": t(hidden, hidden), f"{p}.q_proj.bias": t(hidden),
                   f"{p}.k_proj.weight": t(hidden, hidden), f"{p}.k_proj.bias": t(hidden),
                   f"{p}.v_proj.weight": t(3 * hidden, hidden), f"{p}.v_proj.bias": t(3 * hidden),
                   f"{p}.o_proj.weight": t(3 * hidden, hidden), f"{p}.o_proj.bias": t(3 * hidden),
                   f"{p}.vec_proj.weight": t(3 * hidden, hidden),
                   f"{p}.dk_proj.weight": t(hidden, r), f"{p}.dk_proj.bias": t(hidden),
                   f"{p}.dv_proj.weight": t(3 * hidden, r), f"{p}.dv_proj.bias": t(3 * hidden)})
    path = str(tmp_path / "frad_qm9.ckpt")
    torch.save({"state_dict": {f"representation_model.{k}": v for k, v in sd.items()},
                "hyper_parameters": {}}, path)
    inputs = _inputs(2)
    jmodel = jet.TorchMDET(hidden=hidden, num_rbf=r, num_layers=layers, max_z=max_z,
                           num_heads=4)
    jx, jvec = jmodel.apply(jet.convert_torchmd_et({k: v.numpy() for k, v in sd.items()},
                                                   num_layers=layers),
                            *(jnp.asarray(x) for x in inputs))
    port_sd = tet.load_torchmd_et_checkpoint(path)
    assert set(port_sd) == set(sd)
    frad = tet.frad_from_state_dict(port_sd, num_heads=4)
    with torch.no_grad():
        x, vec = frad.et(*(torch.tensor(a) for a in inputs))
        rep = frad(*(torch.tensor(a) for a in inputs))
    _close(x.numpy(), jx, "x")
    _close(vec.numpy(), jvec, "vec")
    assert torch.isfinite(rep).all() and rep.shape == (3, hidden)


def _rotation(seed=0):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.tensor(q, dtype=torch.float32)


def test_invariance_equivariance_and_masking():
    model = tet.FradEncoder(tet.TorchMDET(**SMALL)).initialize_weights(
        torch.Generator().manual_seed(0)).eval()
    z, pos, mask = (torch.tensor(a) for a in _inputs(4))
    rot = _rotation()
    with torch.no_grad():
        x, vec = model.et(z, pos, mask)
        x_r, vec_r = model.et(z, pos @ rot.T + 7.0, mask)
        moved = pos.clone()
        moved[1, 5:] += 100.0
        x_m, _ = model.et(z, moved, mask)
        rep = model(z, pos, mask)
        perm = torch.tensor([3, 1, 0, 2, 4, 5, 6])
        rep_p = model(z[:, perm], pos[:, perm], mask[:, perm])
    assert (x_r - x).abs().max() <= 1e-4 * x.abs().max()
    assert (vec_r - torch.einsum("ij,bnjh->bnih", rot, vec)).abs().max() \
        <= 1e-4 * vec.abs().max()
    torch.testing.assert_close(x_m[1, :5], x[1, :5])
    assert (x[1, 5:] == 0).all()
    assert (rep_p - rep).abs().max() <= 1e-5 * rep.abs().max()


def test_cutoff_and_rbf_match_jax():
    d = np.array([0.0, 2.5, 4.99, 5.01, 10.0], np.float32)
    np.testing.assert_allclose(tet.cosine_cutoff(torch.tensor(d)).numpy(),
                               np.asarray(jet.cosine_cutoff(jnp.asarray(d))), atol=1e-7)
    np.testing.assert_allclose(tet.cosine_cutoff(torch.tensor(d), 5.0, 1.0).numpy(),
                               np.asarray(jet.cosine_cutoff(jnp.asarray(d), 5.0, 1.0)),
                               atol=1e-7)
    rbf = jet.ExpNormalSmearing(num_rbf=8)
    ref = rbf.apply(rbf.init(jax.random.PRNGKey(0), jnp.asarray(d)), jnp.asarray(d))
    out = tet.ExpNormalSmearing(num_rbf=8)(torch.tensor(d))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def test_modules_follow_the_device_context():
    """Every parameter is made on the device a torch.device context names
    (the card in chip_smoke.py and precompute_mol_reps), the RBF table too."""
    from reed_tpu_torch.encoders.unimol import UniMolGlobal

    with torch.device("meta"):
        models = (tet.FradEncoder(tet.TorchMDET(**SMALL)), UniMolGlobal(layers=1))
    for model in models:
        assert {p.device.type for p in model.parameters()} == {"meta"}
