"""reed_tpu_torch attention against reed_tpu's on the CPU: the plain path
against sdpa_xla and the Pallas kernel in interpret mode, gradients, masks.
The CUDA kernel itself is held against its plain version by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reed_tpu.ops.attention import sdpa_xla
from reed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.ops.attention import multi_head_attention, sdpa

torch.set_num_threads(1)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 16, 4, 8), (1, 256, 2, 72)])
@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_matches_sdpa_xla(shape, impl):
    q, k, v = _qkv(shape)
    out = multi_head_attention(*map(torch.tensor, (q, k, v)), impl=impl)
    ref = np.asarray(sdpa_xla(q, k, v))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_matches_pallas_kernel_in_interpret_mode():
    q, k, v = _qkv((1, 128, 2, 16))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash_attention(q, k, v))
    out = multi_head_attention(*map(torch.tensor, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=0)


def test_gradient_matches_jax():
    q, k, v = _qkv((2, 32, 2, 72))
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def loss_jax(q, k, v):
        return (sdpa_xla(q, k, v) * w).sum()

    g_jax = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    # the autograd.Function of the kernel path: plain forward on the CPU,
    # backward recomputed through the plain version
    (fa.flash_attention(qt, kt, vt) * torch.tensor(w)).sum().backward()
    for a, b in zip((qt.grad, kt.grad, vt.grad), g_jax):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_masked_matches_jax():
    q, k, v = _qkv((1, 6, 2, 8))
    mask = np.ones((1, 1, 6, 6), bool)
    mask[..., 4:] = False
    ref = np.asarray(sdpa_xla(q, k, v, mask=jnp.asarray(mask)))
    out = multi_head_attention(*map(torch.tensor, (q, k, v)),
                               mask=torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # equals attention over the first four keys only
    first4 = sdpa(torch.tensor(q), torch.tensor(k[:, :4]), torch.tensor(v[:, :4]))
    np.testing.assert_allclose(out.numpy(), first4.numpy(), atol=1e-5, rtol=0)


def test_cpu_path_runs_no_kernel_and_kernel_entry_refuses_cpu():
    q, k, v = map(torch.tensor, _qkv((1, 8, 1, 4)))
    before = fa.launches
    multi_head_attention(q, k, v)
    assert fa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="impl"):
        multi_head_attention(q, k, v, impl="xla")
