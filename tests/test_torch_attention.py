"""reed_tpu_torch attention against reed_tpu's on the CPU: the plain path
against sdpa_xla and the Pallas kernel in interpret mode, the plain version
at the kernel's rounding points against the Pallas kernel, the kernel's
layout check, gradients, masks, and a CPU emulation of the f32 kernel's
3xTF32 arithmetic. The CUDA kernel itself is held against its plain version
by chip_smoke.py (and by the cuda-marked test on a card)."""

import math

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
from reed_tpu_torch.ops import fused_message as fm
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


@pytest.mark.parametrize("make,cause", [
    (lambda: _sit_qkv(2, 64, 4, 70, dtype=torch.float32), None),  # any D: 4-byte copies
    (lambda: _sit_qkv(2, 64, 4, 3, dtype=torch.float32), None),
    (lambda: [torch.zeros((2, 64, 4, 76))[..., :72]] * 3, None),  # any stride
    (lambda: [torch.zeros((2 * 64 * 4 * 72 + 1,))[1:].view(2, 64, 4, 72)] * 3, None),  # base
    (lambda: _sit_qkv(2, 64, 1, 136, dtype=torch.float32), "head dim 136 > 128"),
    (lambda: [torch.zeros((2, 64, 72, 4)).transpose(2, 3)] * 3, "contiguous"),
], ids=["D70", "D3", "stride", "base", "D136", "head-dim-stride"])
def test_layout_check_f32(make, cause):
    """The f32 (3xTF32) kernel takes any D <= 128 with the head dim
    contiguous: 16-byte copies where D % 4 == 0 and every base and stride
    allows, 4-byte copies otherwise."""
    if cause is None:
        _layout(*make())
    else:
        with pytest.raises(ValueError, match=cause):
            _layout(*make())


# The f32 kernel's arithmetic on the CPU. Each operand of both products is
# split as the kernel splits it: hi = round_to_tf32(x), lo = x - hi read as
# TF32 by the tensor core (its low 13 bits dropped); a product is lo.hi +
# hi.lo + hi.hi with f32 accumulation. P V reads each 8-key slice in the
# kernel's permuted order (A fragment word t is key 2t, t + 4 is key 2t + 1).
KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _truncate_tf32(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, products):
    ah, bh = fm.round_to_tf32(a), fm.round_to_tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _truncate_tf32(a - ah), _truncate_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_emulation(q, k, v, products=3, block_n=64, key_order=KEY_ORDER):
    """The f32 kernel's algorithm: 64-key tiles (the ragged last one zero-
    filled, its logits -inf), online softmax on exp2 of pre-scaled logits, p
    kept in f32, TF32 products with `products` terms each."""
    b, s, h, d = q.shape
    scale_log2 = d ** -0.5 * math.log2(math.e)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    order = torch.tensor([8 * (i // 8) + key_order[i % 8] for i in range(block_n)])
    for k0 in range(0, s, block_n):
        n = min(block_n, s - k0)
        kt, vt = (torch.zeros((b, h, block_n, d)) for _ in range(2))
        kt[:, :, :n], vt[:, :, :n] = kh[:, :, k0:k0 + n], vh[:, :, k0:k0 + n]
        logits = _mm_tf32(qh, kt.transpose(-1, -2), products)
        logits[..., n:] = -math.inf
        m_new = torch.maximum(m, logits.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(logits * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm_tf32(p[..., order], vt[:, :, order], products)
        m = m_new
    return (acc / l[..., None]).transpose(1, 2)


EMULATED_SHAPES = [(2, 64, 4, 72), (2, 200, 4, 72), (2, 64, 2, 64)]


@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_3xtf32_attention_keeps_f32_accuracy(shape):
    """3xTF32 attention lands within 1e-5 of plain f32 attention (the port's
    and reed_tpu's), and the permuted key order changes nothing but the
    summation order."""
    q, k, v = _qkv(shape, seed=5)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    out = _kernel_emulation(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), fa.sdpa_reference(tq, tk, tv).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(sdpa_xla(q, k, v)), atol=1e-5, rtol=0)
    natural = _kernel_emulation(tq, tk, tv, key_order=list(range(8)))
    np.testing.assert_allclose(out.numpy(), natural.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_1xtf32_attention_breaks_the_f32_tolerance(shape):
    """One TF32 product a piece keeps ~3 digits: on N(0, 1) inputs it is
    above chip_smoke.py's f32 atol of 1e-4 and 100x further off than
    3xTF32, which is why the kernel runs three."""
    q, k, v = map(torch.tensor, _qkv(shape, seed=5))
    ref = fa.sdpa_reference(q, k, v)
    err1 = (_kernel_emulation(q, k, v, products=1) - ref).abs().max().item()
    err3 = (_kernel_emulation(q, k, v) - ref).abs().max().item()
    assert err1 > 1e-4 and err1 > 100 * err3, (err1, err3)


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_kernel_matches_reference_on_sit_qkv_views(s, dtype):
    """On the card: K1 on SiT's strided qkv views against its plain version
    (bf16: at the kernel's rounding points, atol 8e-3; f32, 3xTF32:
    sdpa_reference, atol 1e-4), one launch, no copy of q, k, v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((2, s, 3, 4, 72), generator=gen, device="cuda").to(getattr(torch, dtype))
    q, k, v = qkv.unbind(2)
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    assert fa.launches == before + 1
    if dtype == "bfloat16":
        ref, atol = fa.flash_attention_reference(q, k, v), 8e-3
    else:
        ref, atol = fa.sdpa_reference(q, k, v), 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
