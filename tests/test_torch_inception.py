"""encoders/inception.py against reed_tpu/encoders/inception.py on the CPU:
one set of seeded weights with nonzero BatchNorm statistics, in torchvision
and pytorch-fid names, carried into reed_tpu by its own
convert_torch_inception; the full trunk on two 139 x 139 inputs (the
smallest the trunk takes: its strides reduce 139 to 3 x 3 before the last
blocks), the 256 -> 299 preprocess, and reed_tpu's save_variables_npz
file. Features are held to 1e-5 of their max: both sides compute in f32
and differ by summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reed_tpu.encoders import inception as jax_inception
from reed_tpu_torch.encoders import inception
from reed_tpu_torch.tools import seeded_weights

torch.set_num_threads(1)
RTOL = 1e-5


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_trunk_matches_reed_tpu_through_its_converter(tmp_path):
    model = seeded_weights.inception_v3(1)
    sd = model.state_dict()
    assert sd["Mixed_5b.branch1x1.bn.running_mean"].abs().max() > 0  # nonzero statistics
    variables = jax_inception.convert_torch_inception(sd)
    mine = inception.to_flax(model)
    fa = jax.tree_util.tree_flatten_with_path(variables)[0]
    fb = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(fa, fb))

    x = np.random.default_rng(0).uniform(-1, 1, (2, 139, 139, 3)).astype(np.float32)
    want = np.asarray(jax_inception.InceptionV3Pool3().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) < RTOL
    assert np.abs(want[0] - want[1]).max() > 0.01 * np.abs(want).max()  # inputs matter

    # reed_tpu's npz (params/ and batch_stats/) loads into the port unchanged
    path = str(tmp_path / "inception.npz")
    jax_inception.save_variables_npz(path, variables)
    loaded = inception.load_npz(path, device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))


def test_preprocess_matches_jax_resize():
    """uint8 256 x 256 -> [-1, 1] at 299 (bilinear), as jax.image.resize."""
    images = np.random.default_rng(2).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(jax_inception.preprocess_uint8(jnp.asarray(images)))
    got = inception.preprocess_uint8(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 299, 299, 3)
    assert np.abs(got - want).max() < 1e-5
    same = np.random.default_rng(2).integers(0, 256, (1, 299, 299, 3), dtype=np.uint8)
    np.testing.assert_array_equal(inception.preprocess_uint8(torch.from_numpy(same)).numpy(),
                                  same / np.float32(255.0) * 2 - 1)


def test_feature_fn_matches_reed_tpu():
    """make_feature_fn (preprocess and trunk) on uint8 images, against
    reed_tpu's eager forward of the same variables."""
    model = seeded_weights.inception_v3(2)
    variables = jax_inception.convert_torch_inception(model.state_dict())
    images = np.random.default_rng(3).integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)
    want = np.asarray(jax_inception.InceptionV3Pool3().apply(
        variables, jax_inception.preprocess_uint8(jnp.asarray(images))))
    got = inception.make_feature_fn(model)(images)
    assert got.dtype == np.float32 and got.shape == (2, 2048)
    assert _rel(got, want) < RTOL
