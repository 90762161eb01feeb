"""reed_tpu_torch's fused message MLP against reed_tpu's on the CPU: the
plain version against the direct form in every mask/output mode, against
the Pallas kernel in interpret mode (f32 and bf16), and its gradients. The
CUDA kernel itself is held against the plain version by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.ops.fused_message import fused_message_mlp as jax_fused_message_mlp
from reed_tpu.ops.graph import gather_nodes as jax_gather_nodes
from reed_tpu_torch.ops import fused_message as fm

torch.set_num_threads(1)

ATOL = 2e-5  # as tests/test_fused_message.py; f32 summation order only
DIFF_NAMES = ("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3", "b3")


def _gelu(x):
    return jax.nn.gelu(x, approximate=False)


def _jax_direct(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
                mask, mask_mode, scale):
    """tests/test_fused_message.py's `_direct`, transcribed."""
    et = e_feat @ w_e + jax_gather_nodes(nbr_src, e_idx)
    if mask_mode == "pre":
        et = et * mask[..., None]
    pre = et + pre_self[:, :, None, :]
    m = _gelu(_gelu(pre) @ w2 + b2) @ w3 + b3
    if mask_mode == "post":
        m = m * mask[..., None]
    return jnp.sum(m, axis=2) / scale, m


def _inputs(seed=0, B=2, L=16, K=4, D=128, Ce=256):
    rng = np.random.default_rng(seed)
    s = 0.3

    def randn(*shape):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(pre_self=randn(B, L, D), e_feat=randn(B, L, K, Ce),
                nbr_src=randn(B, L, D),
                e_idx=rng.integers(0, L, (B, L, K)).astype(np.int32),
                w_e=randn(Ce, D), w2=randn(D, D), b2=randn(D), w3=randn(D, D),
                b3=randn(D), mask=(rng.random((B, L, K)) < 0.8).astype(np.float32))


def _flags(outputs):
    return dict(want_sum=outputs in ("sum", "both"),
                want_msg=outputs in ("msg", "both"))


def _port(inp, mask_mode, outputs, dtype=torch.float32, **override):
    t = {k: torch.tensor(v) for k, v in inp.items()}
    t.update(override)
    t = {k: v.to(dtype) if v.is_floating_point() and k != "mask" else v
         for k, v in t.items()}
    mask = None if mask_mode == "none" else t["mask"]
    return fm.fused_message_mlp(
        *(t[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                         "b2", "w3", "b3")),
        mask=mask, mask_mode=mask_mode, scale=30.0, **_flags(outputs))


@pytest.mark.parametrize("ce", [128, 256])
@pytest.mark.parametrize("mask_mode", ["none", "pre", "post"])
@pytest.mark.parametrize("outputs", ["sum", "msg", "both"])
def test_plain_matches_direct(mask_mode, outputs, ce):
    inp = _inputs(Ce=ce)
    dh, msg = _port(inp, mask_mode, outputs)
    mask = inp["mask"] if mask_mode != "none" else np.ones_like(inp["mask"])
    ref_dh, ref_msg = _jax_direct(
        *(inp[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                           "b2", "w3", "b3")), mask, mask_mode, 30.0)
    flags = _flags(outputs)
    assert (dh is None) != flags["want_sum"] and (msg is None) != flags["want_msg"]
    if flags["want_sum"]:
        np.testing.assert_allclose(dh.numpy(), ref_dh, rtol=ATOL, atol=ATOL)
    if flags["want_msg"]:
        np.testing.assert_allclose(msg.numpy(), ref_msg, rtol=ATOL, atol=ATOL)


def _pallas(inp, mask_mode, outputs, dtype=jnp.float32):
    j = {k: jnp.asarray(v).astype(dtype) if v.dtype == np.float32 and k != "mask"
         else jnp.asarray(v) for k, v in inp.items()}
    return jax_fused_message_mlp(
        *(j[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                         "b2", "w3", "b3")),
        mask=None if mask_mode == "none" else j["mask"], mask_mode=mask_mode,
        scale=30.0, interpret=True, **_flags(outputs))


# the three (mask, outputs) combinations the model launches
MODEL_MODES = [("post", "sum"), ("none", "msg"), ("pre", "both")]


@pytest.mark.parametrize("mask_mode,outputs", MODEL_MODES)
def test_plain_matches_pallas_interpret(mask_mode, outputs):
    inp = _inputs(seed=1, D=128, Ce=128 if outputs != "both" else 256)
    for port, ref in zip(_port(inp, mask_mode, outputs),
                         _pallas(inp, mask_mode, outputs)):
        assert (port is None) == (ref is None)
        if ref is not None:
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       rtol=ATOL, atol=ATOL)


def test_bf16_plain_matches_pallas_interpret():
    """Both round m1, m2 and the outputs to bf16 at the same points and
    accumulate in f32; they differ where a summation-order difference flips
    a rounding: one bf16 ulp of an output (2^-6 for |x| < 4)."""
    inp = _inputs(seed=2, Ce=256)
    for name in ("w_e", "w2", "w3"):  # weights ~ N(0, 1/fan_in): O(1) outputs
        inp[name] = inp[name] / (0.3 * np.sqrt(inp[name].shape[0]))
    port = _port(inp, "pre", "both", dtype=torch.bfloat16)
    ref = _pallas(inp, "pre", "both", dtype=jnp.bfloat16)
    for p, r in zip(port, ref):
        assert p.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(r).max() < 4.0
        np.testing.assert_allclose(p.float().numpy(), r, rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("mask_mode,outputs", MODEL_MODES)
def test_cpu_gradients_match_jax(mask_mode, outputs):
    """On the CPU the plain version keeps ordinary autograd."""
    inp = _inputs(seed=3, Ce=256)
    rng = np.random.default_rng(4)
    cot_dh = rng.standard_normal(inp["pre_self"].shape).astype(np.float32)
    cot_msg = rng.standard_normal(inp["e_feat"].shape[:3] + (128,)).astype(np.float32)
    flags = _flags(outputs)
    mask = inp["mask"] if mask_mode != "none" else np.ones_like(inp["mask"])

    def loss(*args):
        dh, msg = _jax_direct(*args[:3], inp["e_idx"], *args[3:], mask, mask_mode, 30.0)
        tot = 0.0
        if flags["want_sum"]:
            tot += jnp.sum(dh * cot_dh)
        if flags["want_msg"]:
            tot += jnp.sum(msg * cot_msg)
        return tot

    ref = jax.grad(loss, argnums=tuple(range(len(DIFF_NAMES))))(
        *(inp[n] for n in DIFF_NAMES))
    leaves = {n: torch.tensor(inp[n], requires_grad=True) for n in DIFF_NAMES}
    dh, msg = _port(inp, mask_mode, outputs, **leaves)
    tot = 0.0
    if flags["want_sum"]:
        tot = tot + (dh * torch.tensor(cot_dh)).sum()
    if flags["want_msg"]:
        tot = tot + (msg * torch.tensor(cot_msg)).sum()
    grads = torch.autograd.grad(tot, [leaves[n] for n in DIFF_NAMES])
    for name, g, r in zip(DIFF_NAMES, grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-5, atol=3e-5,
                                   err_msg=name)


def test_arguments_are_checked():
    inp = _inputs(seed=5, Ce=128)
    with pytest.raises(ValueError, match="want_sum"):
        _port(inp, "post", "neither")
    with pytest.raises(ValueError, match="mask_mode"):
        _port(inp, "sideways", "sum")
    # the kernel's own entry refuses CPU tensors: it launches or raises
    t = {k: torch.tensor(v) for k, v in inp.items()}
    before = fm.launches
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_message_kernel(
            *(t[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                             "b2", "w3", "b3")), mask=t["mask"])
    assert fm.launches == before


def test_no_mask_means_mode_none():
    inp = _inputs(seed=6, Ce=128)
    t = {k: torch.tensor(v) for k, v in inp.items()}
    args = [t[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                           "b2", "w3", "b3")]
    _, a = fm.fused_message_mlp(*args, mask=None, mask_mode="post",
                                want_sum=False, want_msg=True)
    _, b = fm.fused_message_mlp(*args, mask=t["mask"], mask_mode="none",
                                want_sum=False, want_msg=True)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_backward():
    """On the card: K2a against the plain forward, and the autograd backward
    (K2b) against the plain backward, with one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    inp = _inputs(seed=7, Ce=256)
    t = {k: torch.tensor(v, device="cuda") for k, v in inp.items()}
    args = [t[n] for n in ("pre_self", "e_feat", "nbr_src", "e_idx", "w_e", "w2",
                           "b2", "w3", "b3")]
    before = fm.launches
    dh, msg = fm.fused_message_mlp(*args, mask=t["mask"], mask_mode="pre",
                                   want_sum=True, want_msg=True)
    assert fm.launches == before + 1
    ref_dh, ref_msg = fm.fused_message_reference(*args, mask=t["mask"], mask_mode="pre",
                                                 want_sum=True, want_msg=True)
    torch.testing.assert_close(dh, ref_dh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(msg, ref_msg, rtol=1e-4, atol=1e-4)
    leaves = [a.clone().requires_grad_() if a.is_floating_point() else a for a in args]
    gdh = torch.randn_like(dh)
    before = fm.backward_launches
    dh, _ = fm.fused_message_mlp(*leaves, mask=t["mask"], mask_mode="post")
    grads = torch.autograd.grad((dh * gdh).sum(), [a for a in leaves if a.requires_grad])
    assert fm.backward_launches == before + 1
    ref = fm.fused_message_backward_reference(*args, gdh=gdh, gmsg=None, mask=t["mask"],
                                              mask_mode="post")
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
