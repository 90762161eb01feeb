"""Flash attention: the hand-written CUDA kernel K1 and its plain version.

Replaces the TPU kernel `_attn_kernel` (reed_tpu/ops/flash_attention.py,
launched by `_flash_forward`). The kernel is `csrc/flash_attention.cu`:
one block per (query tile, batch*head), K and V streamed through shared
memory with an online softmax in f32, output written once in the input
dtype. On the H100, at SiT-XL/2's S = 256 in bf16, it is bound by bytes
(q, k, v read once, o written once): S/2 = 128 flops per byte, below the
card's ~295 flops/byte ridge. Its measured time beside that bound is in
PERF.md (chip_smoke.py).

A CUDA tensor launches the kernel or raises; a CPU tensor runs
`sdpa_reference`, the plain version. The backward, as in the JAX
`_flash_bwd_rule`, is not a kernel: it recomputes through `sdpa_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from reed_tpu_torch import _build

# Kernel launches since the count was last set to 0; a run reads it to show
# that it went through the kernel.
launches = 0

_MAX_HEAD_DIM = 128


def sdpa_reference(q, k, v, mask=None):
    """Plain scaled dot-product attention on [B, S, H, D]; logits scaled by
    D^-1/2, softmax in f32 and cast back (the counterpart of sdpa_xla).
    `mask` (bool, broadcastable to [B, H, Sq, Sk]) keeps the True keys."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@functools.cache
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.reed_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.reed_cuda_error_string.argtypes = [ctypes.c_int]
    lib.reed_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention kernel: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError("flash attention kernel takes f32 or bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or not (k.shape == v.shape == q.shape):
        raise ValueError("flash attention kernel takes q, k, v of one shape "
                         f"[B, S, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel: head dim {q.shape[-1]} > "
                         f"{_MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs the head dim contiguous "
                         "(stride 1)")


def flash_attention_kernel(q, k, v):
    """Launch the CUDA kernel on the current stream: [B, S, H, D] -> same."""
    global launches
    _check(q, k, v)
    lib = _kernel()
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.reed_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, h, d, *strides, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.reed_cuda_error_string(err).decode())
    launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return sdpa_reference(q, k, v)
        return flash_attention_kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = sdpa_reference(q, k, v)
        return torch.autograd.grad(out, (q, k, v), g)


def flash_attention(q, k, v, mask=None):
    """q, k, v: [B, S, H, D] -> [B, S, H, D]. Differentiable. A masked call
    runs the plain version (SiT attention is unmasked)."""
    if mask is not None:
        return sdpa_reference(q, k, v, mask=mask)
    return _FlashAttention.apply(q, k, v)
