"""reed_tpu_torch's SO(3) utilities, SE(3) interpolant and backbone
construction against reed_tpu's on the CPU: the exp/log maps (finite
gradients at theta 0 and near pi), IGSO3 and uniform rotations and
corrupt_batch with reed_tpu's draws handed over in its split order (1e-5),
the batch-OT prior from one numpy generator (the same assignment, values to
1e-5), and to_atom37 / torsion_frames / frames_to_atom14."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.diffusion import se3 as jse3
from reed_tpu.ops import residue_constants as jrc
from reed_tpu.ops import so3 as jso3
from reed_tpu_torch.diffusion import se3
from reed_tpu_torch.ops import residue_constants as rc
from reed_tpu_torch.ops import so3

torch.set_num_threads(1)
TOL = 1e-5


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)) if dtype is None else torch.from_numpy(
        np.array(x)).to(dtype)


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.standard_normal((int(np.prod(shape)), 3, 3)))
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q.reshape(tuple(shape) + (3, 3)).astype(np.float32)


def _rotvecs():
    """Random rotvecs with |v| < pi, plus theta = 0, tiny and near pi."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((16, 3))
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) * rng.uniform(0.05, 3.0, (16, 1))
    axis = np.array([0.6, -0.8, 0.0])
    special = [np.zeros(3), 1e-5 * axis, (np.pi - 1e-4) * axis, (np.pi - 2e-3) * axis]
    return np.concatenate([v, np.stack(special)]).astype(np.float32)


def test_exp_log_maps_match_jax():
    v = _rotvecs()
    rot = so3.rotvec_to_rotmat(_t(v))
    jrot = np.asarray(jso3.rotvec_to_rotmat(jnp.asarray(v)))
    np.testing.assert_allclose(rot.numpy(), jrot, atol=TOL)
    back = so3.rotmat_to_rotvec(_t(jrot))
    np.testing.assert_allclose(back.numpy(), np.asarray(jso3.rotmat_to_rotvec(jnp.asarray(jrot))),
                               atol=2e-4)
    # the log map inverts the exp map (up to the sign at pi)
    np.testing.assert_allclose(back[:-2].numpy(), v[:-2], atol=2e-3)
    rng = np.random.default_rng(1)
    a, b = _rotations(rng, (8,)), _rotations(rng, (8,))
    t = np.float32(0.3)
    np.testing.assert_allclose(so3.calc_rot_vf(_t(a), _t(b)).numpy(),
                               np.asarray(jso3.calc_rot_vf(jnp.asarray(a), jnp.asarray(b))),
                               atol=TOL)
    np.testing.assert_allclose(
        so3.geodesic_t(t, _t(b), _t(a)).numpy(),
        np.asarray(jso3.geodesic_t(t, jnp.asarray(b), jnp.asarray(a))), atol=TOL)


def test_log_map_gradients_finite_at_zero_and_pi():
    v = _t(_rotvecs()).requires_grad_(True)
    rot = so3.rotvec_to_rotmat(v)
    eye = torch.eye(3).expand(2, 3, 3).clone().requires_grad_(True)
    out = so3.rotmat_to_rotvec(rot).sum() + so3.rotmat_to_rotvec(eye).sum()
    gv, ge = torch.autograd.grad(out, [v, eye])
    assert torch.isfinite(gv).all() and torch.isfinite(ge).all()
    # and they agree with reed_tpu's, away from pi (where f32 alone moves the
    # gradient of this ill-conditioned map by a few per cent)
    jg = jax.grad(lambda x: jso3.rotmat_to_rotvec(jso3.rotvec_to_rotmat(x)).sum())(
        jnp.asarray(_rotvecs()))
    np.testing.assert_allclose(gv[:-2].numpy(), np.asarray(jg)[:-2], atol=1e-4)


def test_igso3_and_uniform_rotations_match_jax():
    key = jax.random.PRNGKey(3)
    shape = (4, 9)
    want = np.asarray(jso3.sample_igso3(key, 1.5, shape))
    r_u, r_axis = jax.random.split(key)
    u = _t(jax.random.uniform(r_u, shape))
    axis = _t(jax.random.normal(r_axis, shape + (3,)))
    got = so3.sample_igso3(1.5, shape, u=u, axis=axis)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    sigmas, table = so3.igso3_inverse_cdf_table()
    jsigmas, jtable = jso3.igso3_inverse_cdf_table()
    assert np.array_equal(sigmas, jsigmas) and np.array_equal(table, jtable)
    # sigma 0.3 is not on the grid: the first sigma at or above it
    assert np.asarray(jso3.sample_igso3(key, 0.3, shape)).shape == shape + (3, 3)
    np.testing.assert_allclose(
        so3.sample_igso3(0.3, shape, u=u, axis=axis).numpy(),
        np.asarray(jso3.sample_igso3(key, 0.3, shape)), atol=TOL)
    q = jax.random.normal(key, shape + (4,))
    np.testing.assert_allclose(
        so3.sample_uniform_rotations(shape, q=_t(q)).numpy(),
        np.asarray(jso3.sample_uniform_rotations(key, shape)), atol=TOL)


def corrupt_draws(key, cfg, b, n, with_trans_noise=True):
    """reed_tpu's draws inside corrupt_batch at `key`, in its split order."""
    r_t, r_tr, r_rot, r_cat = jax.random.split(key, 4)
    r_u, r_axis = jax.random.split(r_rot)
    uniform = (_t(jax.random.randint(jax.random.fold_in(r_cat, 1), (b, n), 0, 20), torch.long)
               if cfg.aatypes_interpolant == "uniform" else None)
    return se3.CorruptDraws(
        t_u=_t(jax.random.uniform(r_t, (b, 1))),
        trans_noise=_t(jax.random.normal(r_tr, (b, n, 3))) if with_trans_noise else None,
        rot_u=_t(jax.random.uniform(r_u, (b, n))),
        rot_axis=_t(jax.random.normal(r_axis, (b, n, 3))),
        aatypes_u=_t(jax.random.uniform(r_cat, (b, n))), aatypes_uniform=uniform)


def _structure_batch(b=3, n=10, seed=0, pad=2):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[-1, n - pad:] = 0.0
    return {"trans_1": (rng.standard_normal((b, n, 3)) * 5).astype(np.float32),
            "rotmats_1": _rotations(rng, (b, n)),
            "aatypes_1": rng.integers(0, 20, (b, n)),
            "res_mask": mask,
            "res_idx": np.tile(np.arange(n), (b, 1))}


CORRUPT_CASES = {
    "masking": dict(),
    "uniform_exp": dict(aatypes_interpolant="uniform", rots_train_schedule="exp"),
    "coupled_prior": dict(trans_batch_ot=True),
}


@pytest.mark.parametrize("case", sorted(CORRUPT_CASES))
def test_corrupt_batch_matches_jax(case):
    kw = CORRUPT_CASES[case]
    batch = _structure_batch()
    if kw.get("trans_batch_ot"):
        batch["trans_0"] = jse3.batch_ot_trans_prior(np.random.default_rng(5), batch["trans_1"],
                                                     batch["res_mask"], 10.0)
    jcfg = jse3.SE3InterpolantConfig(**kw)
    cfg = se3.SE3InterpolantConfig(**kw)
    key = jax.random.PRNGKey(11)
    want = jse3.corrupt_batch(key, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    b, n = batch["res_mask"].shape
    draws = corrupt_draws(key, cfg, b, n, with_trans_noise="trans_0" not in batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    got = se3.corrupt_batch(cfg, tbatch, draws)
    for k in ("so3_t", "trans_t", "rotmats_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, err_msg=k)
    assert np.array_equal(got["aatypes_t"].numpy(), np.asarray(want["aatypes_t"]))
    # the trainer's own draws: the same schema, finite, masked rows at identity
    own = se3.corrupt_batch(cfg, tbatch, generator=torch.Generator().manual_seed(0))
    assert own["trans_t"].shape == (b, n, 3) and torch.isfinite(own["rotmats_t"]).all()
    assert torch.equal(own["rotmats_t"][-1, -1], torch.eye(3))
    assert (own["aatypes_t"][-1, -2:] == se3.MASK_TOKEN_INDEX).all()


def test_batch_ot_prior_matches_jax():
    batch = _structure_batch(b=5, n=12, seed=2)
    args = (batch["trans_1"], batch["res_mask"], 10.0)
    got = se3.batch_ot_trans_prior(np.random.default_rng(9), *args)
    want = jse3.batch_ot_trans_prior(np.random.default_rng(9), *args)
    np.testing.assert_allclose(got, want, atol=TOL)
    # the same assignment: each row is the same noise draw's alignment
    assert np.abs(got - want).max() < 1e-5 < np.abs(got[0] - want[1]).max()
    # each noise is aligned onto its structure: the masked centres coincide
    m = batch["res_mask"][..., None]
    np.testing.assert_allclose((got * m).sum(1) / m.sum(1), (batch["trans_1"] * m).sum(1)
                               / m.sum(1), atol=1e-4)


def test_time_grid_matches_jnp_linspace_at_five_steps():
    got = se3.time_grid(0.01, 5).numpy()
    assert np.array_equal(got, np.asarray(jnp.linspace(0.01, 1.0, 5)))
    np.testing.assert_allclose(se3.time_grid(0.01, 100).numpy(),
                               np.asarray(jnp.linspace(0.01, 1.0, 100)), atol=1e-7)


def test_backbone_construction_matches_jax():
    rng = np.random.default_rng(4)
    b, n = 2, 7
    rot = _rotations(rng, (b, n))
    trans = (rng.standard_normal((b, n, 3)) * 4).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[1, 3] = 0.0
    atom37 = rc.to_atom37(_t(trans), _t(rot), res_mask=_t(mask))
    want = jrc.to_atom37(jnp.asarray(trans), jnp.asarray(rot), res_mask=jnp.asarray(mask))
    np.testing.assert_allclose(atom37.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(rc.to_atom37(_t(trans), _t(rot)).numpy(),
                               np.asarray(jrc.to_atom37(jnp.asarray(trans), jnp.asarray(rot))),
                               atol=TOL)
    ang = rng.uniform(-np.pi, np.pi, (b, n, 7))
    sincos = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    aat = rng.integers(0, 20, (b, n))
    fr, ft = rc.torsion_frames(_t(rot), _t(trans), _t(sincos), _t(aat))
    jfr, jft = jrc.torsion_frames(jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(sincos),
                                  jnp.asarray(aat))
    np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), atol=TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jft), atol=TOL)
    pos, m14 = rc.frames_to_atom14(fr, ft, _t(aat))
    jpos, jm14 = jrc.frames_to_atom14(jfr, jft, jnp.asarray(aat))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=TOL)
    assert np.array_equal(m14.numpy(), np.asarray(jm14))


def test_config_fields_match_jax():
    for ours, theirs in ((se3.SE3InterpolantConfig, jse3.SE3InterpolantConfig),):
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
