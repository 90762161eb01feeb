"""The f32 arithmetic of the fused message kernels (K2a, K2b) on the CPU:
`round_to_tf32` on exact bit patterns, the 3xTF32 split the kernels use
(hi = round_to_tf32(x), lo = x - hi read as TF32 by the tensor core, three
products lo.hi + hi.lo + hi.hi) against the f32 chain and the TF32 chain
against it, and the shapes the tile engine takes. The kernels themselves are
held against their plain versions by chip_smoke.py on the card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reed_tpu_torch.ops import fused_message as fm

torch.set_num_threads(1)

# 3xTF32 products stay within this of the f32 chain, relative to its max;
# one TF32 product a piece (10 mantissa bits) does not
TF32X3_RTOL = 2e-6


def _bits(x):
    return torch.tensor([x], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("x,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # just below the tie: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (not to even)
    (0x3F803000, 0x3F804000),  # 1 + 3 * 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): away from zero, negative
    (0x35800000, 0x35800000),  # 2^-20, a power of two
    (0x3FFFF000, 0x40000000),  # the carry reaches the exponent: 2.0
])
def test_round_to_tf32_bit_patterns(x, want):
    got = fm.round_to_tf32(_bits(x)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert got.item() == want, hex(got.item())


def _truncate_tf32(x):
    """x as the tensor core reads a TF32 operand: the low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    ah, bh = fm.round_to_tf32(a), fm.round_to_tf32(b)
    al, bl = _truncate_tf32(a - ah), _truncate_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return fm.round_to_tf32(a) @ fm.round_to_tf32(b)


def _case(seed=0, B=2, L=16, K=4, D=128, Ce=256):
    rng = np.random.default_rng(seed)

    def randn(*shape, std=1.0):
        return torch.tensor((std * rng.standard_normal(shape)).astype(np.float32))

    return dict(e_feat=randn(B, L, K, Ce), w_e=randn(Ce, D, std=Ce ** -0.5),
                w2=randn(D, D, std=D ** -0.5), w3=randn(D, D, std=D ** -0.5),
                b2=randn(D, std=0.1), b3=randn(D, std=0.1), pre_self=randn(B, L, D, std=0.5),
                nbr=randn(B, L, K, D, std=0.5), g=randn(B * L * K, D))


def _forward_chain(c, mm):
    """The plain forward's three products (fused_message_reference, mode
    none, the gathered rows given), with the product taken by mm."""
    m1 = F.gelu(mm(c["e_feat"], c["w_e"]) + c["nbr"] + c["pre_self"][:, :, None, :])
    m2 = F.gelu(mm(m1, c["w2"]) + c["b2"])
    return mm(m2, c["w3"]) + c["b3"]


def _tn_product(c, mm):
    """dW_e = e_feat^T ge over every edge row, as K2b's weight-gradient kernel."""
    x = c["e_feat"].reshape(-1, c["e_feat"].shape[-1])
    return mm(x.t().contiguous(), c["g"])


@pytest.mark.parametrize("product", [_forward_chain, _tn_product])
def test_3xtf32_keeps_f32_accuracy_and_tf32_does_not(product):
    c = _case()
    ref = product(c, torch.matmul)
    scale = ref.abs().max()
    err3 = ((product(c, _mm_3xtf32) - ref).abs().max() / scale).item()
    err1 = ((product(c, _mm_tf32) - ref).abs().max() / scale).item()
    assert err3 <= TF32X3_RTOL, err3
    assert err1 > TF32X3_RTOL, err1


# chip_smoke.py's MSG_CASES: (B, L, K, D, Ce)
MSG_SHAPES = [(8, 256, 30, 128, 128), (8, 256, 30, 128, 128), (8, 256, 30, 128, 256),
              (3, 100, 30, 128, 256), (2, 16, 4, 32, 64)]


@pytest.mark.parametrize("shape", MSG_SHAPES)
def test_engine_takes_the_checked_cases(shape):
    _, _, k, d, ce = shape
    fm.check_engine_shape(k, d, ce)


@pytest.mark.parametrize("k,d,ce,cause", [
    (30, 136, 128, "D = 136"),  # above one 128-column pass
    (30, 40, 128, "D = 40"),    # not a multiple of 16 (bf16 k-steps)
    (30, 128, 36, "Ce = 36"),   # not a multiple of 8 (16-byte copies)
    (65, 128, 128, "K = 65"),   # above a tile's 64 edge rows
])
def test_engine_refuses_with_the_cause(k, d, ce, cause):
    with pytest.raises(ValueError, match=cause):
        fm.check_engine_shape(k, d, ce)


def test_unaligned_base_is_refused():
    """The kernels copy rows in 16-byte pieces from each float tensor's base:
    a view that starts 4 bytes in is refused, by name."""
    base = torch.zeros(64)
    fm._check_aligned({"e_feat": base[4:], "w_e": None})
    with pytest.raises(ValueError, match="e_feat"):
        fm._check_aligned({"e_feat": base[1:], "w_e": base})
