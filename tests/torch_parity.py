"""Shared pieces of the reed_tpu_torch parity tests (tests/test_torch_*.py):
a tiny SiT built in both frameworks with the same random weights.

Every parameter, adaLN and final layer included, is drawn from a seeded
normal: SiT zero-initialises adaLN_modulation and final_layer, and at init
the attention output never reaches the velocity, so a test at init would
prove nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reed_tpu.models.sit import SiT as JaxSiT
from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
from reed_tpu_torch.models.sit import SiT

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, num_classes=10, encoder_depth=1,
            z_dims=(8,), projector_dim=32)


def random_params(jax_model, std=0.02, seed=0):
    """A numpy param tree of `jax_model` with every leaf ~ N(0, std)."""
    x = jnp.zeros((1, jax_model.input_size, jax_model.input_size,
                   jax_model.in_channels))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
        return_zs=True))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def tiny_pair(std=0.02, seed=0, **overrides):
    """(jax SiT, its numpy variables, port SiT with the same weights)."""
    kw = dict(TINY, **overrides)
    jax_model = JaxSiT(**kw)
    variables = random_params(jax_model, std=std, seed=seed)
    model = SiT(**kw).eval()
    model.load_state_dict(state_dict_from_flax(variables, kw["patch_size"]))
    return jax_model, variables, model


def tiny_inputs(batch=3, seed=1, **overrides):
    """Numpy (x NHWC, t, y) for the tiny SiT; y includes the null class."""
    kw = dict(TINY, **overrides)
    rng = np.random.default_rng(seed)
    size, c = kw["input_size"], kw["in_channels"]
    x = rng.standard_normal((batch, size, size, c)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, batch).astype(np.float32)
    y = rng.integers(0, kw["num_classes"] + 1, batch).astype(np.int32)
    return x, t, y
