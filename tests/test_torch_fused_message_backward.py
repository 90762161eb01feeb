"""The port's plain backward of the fused message MLP (the step-by-step
version the CUDA kernel K2b is held against on the card) against reed_tpu's
backward kernel `_bwd_kernel` run in Pallas interpret mode (jax.vjp of
fused_message_mlp), and against torch autograd of the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reed_tpu.ops.fused_message import fused_message_mlp as jax_fused_message_mlp
from reed_tpu_torch.ops import fused_message as fm

torch.set_num_threads(1)

ATOL = 3e-5  # as tests/test_fused_message.py's gradient checks; f32 summation order
NAMES = ("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3", "b3")
# the three (mask, outputs) combinations the model launches
MODEL_MODES = [("post", "sum"), ("none", "msg"), ("pre", "both")]


def _case(seed, ce, B=2, L=16, K=4, D=128, scale=0.3):
    rng = np.random.default_rng(seed)

    def randn(*shape, std=scale):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    inp = dict(pre_self=randn(B, L, D), e_feat=randn(B, L, K, ce), nbr_src=randn(B, L, D),
               w_e=randn(ce, D), w2=randn(D, D), b2=randn(D), w3=randn(D, D), b3=randn(D))
    e_idx = rng.integers(0, L, (B, L, K)).astype(np.int32)
    mask = (rng.random((B, L, K)) < 0.8).astype(np.float32)
    cot = dict(gdh=randn(B, L, D, std=1.0), gmsg=randn(B, L, K, D, std=1.0))
    return inp, e_idx, mask, cot


def _jax_grads(inp, e_idx, mask, cot, mask_mode, outputs, dtype=jnp.float32):
    want_sum, want_msg = outputs != "msg", outputs != "sum"

    def f(*args):
        return jax_fused_message_mlp(
            *args[:3], jnp.asarray(e_idx), *args[3:],
            mask=None if mask_mode == "none" else jnp.asarray(mask),
            mask_mode=mask_mode, scale=30.0, want_sum=want_sum, want_msg=want_msg,
            interpret=True)

    outs, vjp = jax.vjp(f, *(jnp.asarray(inp[n]).astype(dtype) for n in NAMES))
    cots = tuple(jnp.asarray(cot[k]).astype(dtype) if o is not None else None
                 for k, o in zip(("gdh", "gmsg"), outs))
    return vjp(cots)


def _port_grads(inp, e_idx, mask, cot, mask_mode, outputs, dtype=torch.float32):
    t = {n: torch.tensor(inp[n]).to(dtype) for n in NAMES}
    return fm.fused_message_backward_reference(
        *(t[n] for n in NAMES[:3]), torch.tensor(e_idx), *(t[n] for n in NAMES[3:]),
        gdh=torch.tensor(cot["gdh"]).to(dtype) if outputs != "msg" else None,
        gmsg=torch.tensor(cot["gmsg"]).to(dtype) if outputs != "sum" else None,
        mask=None if mask_mode == "none" else torch.tensor(mask),
        mask_mode=mask_mode, scale=30.0)


@pytest.mark.parametrize("ce", [128, 256])
@pytest.mark.parametrize("mask_mode,outputs", MODEL_MODES)
def test_plain_backward_matches_pallas_interpret(mask_mode, outputs, ce):
    inp, e_idx, mask, cot = _case(seed=ce, ce=ce)
    ref = _jax_grads(inp, e_idx, mask, cot, mask_mode, outputs)
    got = _port_grads(inp, e_idx, mask, cot, mask_mode, outputs)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mask_mode", ["none", "pre", "post"])
@pytest.mark.parametrize("outputs", ["sum", "msg", "both"])
def test_plain_backward_matches_autograd(mask_mode, outputs):
    """Every mask/output mode: the explicit backward is the gradient of the
    plain forward (f32, summation order only)."""
    inp, e_idx, mask, cot = _case(seed=7, ce=64, D=32)
    leaves = {n: torch.tensor(inp[n], requires_grad=True) for n in NAMES}
    m = None if mask_mode == "none" else torch.tensor(mask)
    dh, msg = fm.fused_message_reference(
        *(leaves[n] for n in NAMES[:3]), torch.tensor(e_idx),
        *(leaves[n] for n in NAMES[3:]), mask=m, mask_mode=mask_mode,
        want_sum=outputs != "msg", want_msg=outputs != "sum")
    tot = sum((o * torch.tensor(cot[k])).sum()
              for o, k in ((dh, "gdh"), (msg, "gmsg")) if o is not None)
    want = torch.autograd.grad(tot, [leaves[n] for n in NAMES])
    got = _port_grads(inp, e_idx, mask, cot, mask_mode, outputs)
    for name, g, r in zip(NAMES, got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)


def test_bf16_plain_backward_matches_pallas_interpret():
    """bf16 inputs: both round g3, g2, ge, m1 and m2 to bf16 where they enter
    a product and accumulate in f32, so they differ where a summation-order
    difference flips one rounding: one bf16 ulp of that element, which the
    products it feeds carry. Held relative to each gradient's largest
    element (2^-6, two bf16 ulps)."""
    inp, e_idx, mask, cot = _case(seed=3, ce=256)
    for name in ("w_e", "w2", "w3"):  # weights ~ N(0, 1/fan_in): O(1) activations
        inp[name] = inp[name] / (0.3 * np.sqrt(inp[name].shape[0]))
    ref = _jax_grads(inp, e_idx, mask, cot, "pre", "both", dtype=jnp.bfloat16)
    got = _port_grads(inp, e_idx, mask, cot, "pre", "both", dtype=torch.bfloat16)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        r = np.asarray(r.astype(jnp.float32))
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err <= 2 ** -6, (name, err)


def test_index_outside_graph_adds_nothing():
    """An e_idx outside [0, L) gathers zero and receives no gradient, as the
    kernels' one-hot (TPU) and row test (CUDA) do."""
    inp, e_idx, mask, cot = _case(seed=5, ce=64, D=32)
    e_idx[0, 0, 0] = 16
    e_idx[1, 2, 3] = -1
    t = {n: torch.tensor(inp[n]) for n in NAMES}
    got = fm.fused_message_backward_reference(
        *(t[n] for n in NAMES[:3]), torch.tensor(e_idx), *(t[n] for n in NAMES[3:]),
        gdh=torch.tensor(cot["gdh"]), gmsg=None, mask=torch.tensor(mask),
        mask_mode="post")
    ref = _jax_grads(inp, e_idx, mask, cot, "post", "sum")
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=ATOL, atol=ATOL,
                                   err_msg=name)
