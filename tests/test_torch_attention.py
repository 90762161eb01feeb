"""reed_tpu_torch attention against reed_tpu's on the CPU: the plain path
against sdpa_xla and the Pallas kernel in interpret mode, the plain version
at the kernel's rounding points against the Pallas kernel, the kernel's
layout check, gradients, masks. The CUDA kernel itself is held against its
plain version by chip_smoke.py (and by the cuda-marked test on a card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reed_tpu.ops.attention import sdpa_xla
from reed_tpu.ops.flash_attention import _flash_forward
from reed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch import _build
from reed_tpu_torch.ops.attention import multi_head_attention, sdpa
from reed_tpu_torch.tools.attention_variants import variant_sources

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


# (B, S, H, D), Pallas query block: S = 200 is ragged for the kernel's
# 64-key tiles and takes a query block that divides it
@pytest.mark.parametrize("shape,block_q", [((2, 256, 4, 72), 128), ((2, 200, 4, 72), 40)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_at_kernel_rounding_matches_tpu_kernel(shape, block_q, dtype):
    """flash_attention_reference rounds p to the input dtype before the PV
    product, as the Pallas kernel does: in bf16 it agrees with the kernel
    (interpret mode) to ~1 ulp where sdpa_reference is off by ~1.6e-2; in
    f32 it is exact attention, held against sdpa_xla."""
    q, k, v = _qkv(shape, seed=3)
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    out = fa.flash_attention_reference(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    if dtype == "bfloat16":
        with pltpu.force_tpu_interpret_mode():
            ref = _flash_forward(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                 block_q=block_q)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   atol=2e-3, rtol=0)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(sdpa_xla(q, k, v)),
                                   atol=1e-5, rtol=0)


def _sit_qkv(b, s, h, d, dtype=torch.bfloat16):
    """q, k, v as SiT hands them over: strided views of one [B, S, 3, H, D]."""
    qkv = torch.zeros((b, s, 3, h, d), dtype=dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _layout(q, k, v):
    fa.check_layout(q.shape, q.dtype, [t.stride() for t in (q, k, v)],
                    [t.data_ptr() for t in (q, k, v)])


@pytest.mark.parametrize("dims", [(2, 256, 16, 72), (2, 64, 6, 64)],
                         ids=["SiT-XL/2", "SiT-S/4"])
def test_layout_check_accepts_sit_qkv_views(dims):
    q, k, v = _sit_qkv(*dims)
    assert q.stride() == (dims[1] * 3 * dims[2] * dims[3], 3 * dims[2] * dims[3],
                          dims[3], 1)
    _layout(q, k, v)
    _layout(*_sit_qkv(*dims[:3], 70, dtype=torch.float32))  # f32 takes any D


def _misaligned_stride():
    x = torch.zeros((2, 64, 4, 76), dtype=torch.bfloat16)[..., :72]  # head stride 76
    return x, x, x


def _misaligned_base():
    x = torch.zeros((2 * 64 * 4 * 72 + 4,), dtype=torch.bfloat16)[4:].view(2, 64, 4, 72)
    return x, x, x


@pytest.mark.parametrize("make,cause", [
    (lambda: _sit_qkv(2, 64, 4, 70), "multiple of 8"),
    (lambda: _sit_qkv(2, 64, 1, 136), "head dim 136 > 128"),
    (_misaligned_stride, "stride is not a multiple of 8"),
    (_misaligned_base, "16-byte aligned"),
    (lambda: [torch.zeros((2, 64, 72, 4), dtype=torch.bfloat16).transpose(2, 3)] * 3,
     "contiguous"),
], ids=["D70", "D136", "stride", "base", "head-dim-stride"])
def test_layout_check_rejects_with_cause(make, cause):
    with pytest.raises(ValueError, match=cause):
        _layout(*make())


def test_attention_variants_still_edit_the_kernel_source():
    """Each design variant of tools/attention_variants.py changes the
    current kernel source, and only where it means to."""
    source = (_build.CSRC / "flash_attention.cu").read_text()
    variants = variant_sources(source)
    assert variants.pop("as built") == source
    assert all(text != source for text in variants.values())
    with pytest.raises(ValueError, match="not in the source once"):
        variant_sources("// no kernel here")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 200])
def test_cuda_kernel_matches_reference_on_sit_qkv_views(s):
    """On the card: bf16 K1 on SiT's strided qkv views against the plain
    version at its rounding points, one launch, no copy of q, k, v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((2, s, 3, 4, 72), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    assert fa.launches == before + 1
    torch.testing.assert_close(out.float(), fa.flash_attention_reference(q, k, v).float(),
                               atol=8e-3, rtol=0)
