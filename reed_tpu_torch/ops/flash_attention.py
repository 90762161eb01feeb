"""Flash attention: the hand-written CUDA kernel K1 and its plain version.

Replaces the TPU kernel `_attn_kernel` (reed_tpu/ops/flash_attention.py,
launched by `_flash_forward`). The kernel is `csrc/flash_attention.cu`:
one block per (query tile, batch*head), K and V streamed through shared
memory with an online softmax in f32, output written once in the input
dtype. Both products run on the tensor cores: in bf16, with p rounded to
bf16 where it enters the PV product, as in the TPU kernel; in f32 as
3xTF32 (each operand split into a TF32 hi and lo, three TF32 products a
piece), which keeps f32 accuracy. On the H100, at SiT-XL/2's S = 256 in
bf16, it is bound by bytes (q, k, v read once, o written once): S/2 = 128
flops per byte, below the card's ~295 flops/byte ridge; in f32 by
operations (3xTF32 at 165 TF/s). Its measured times beside those bounds
are in PERF.md (chip_smoke.py).

`flash_attention_reference` is the plain version at the kernel's rounding
points; `sdpa_reference` is the counterpart of reed_tpu's `sdpa_xla`.
A CUDA tensor launches the kernel or raises (`check_layout` says which
layouts it takes); a CPU tensor runs `sdpa_reference`, as reed_tpu's SiT
runs `sdpa_xla` on the CPU. The backward, as in the JAX `_flash_bwd_rule`,
is not a kernel: it recomputes through `sdpa_reference`. Queries and keys
may differ in length (q [B, Sq, H, D] against k, v [B, Sk, H, D]): under
SiT's sequence parallelism a rank's queries are its own tokens and its keys
every rank's.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from reed_tpu_torch import _build

# Kernel launches since the count was last set to 0; a run reads it to show
# that it went through the kernel.
launches = 0

_MAX_HEAD_DIM = 128


def sdpa_reference(q, k, v, mask=None):
    """Plain scaled dot-product attention, q [B, Sq, H, D] against k, v
    [B, Sk, H, D]; logits scaled by D^-1/2, softmax in f32 and cast back
    (the counterpart of sdpa_xla).
    `mask` (bool, broadcastable to [B, H, Sq, Sk]) keeps the True keys."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_reference(q, k, v):
    """Plain attention, q [B, Sq, H, D] against k, v [B, Sk, H, D], at the
    kernel's (and the TPU kernel's) rounding points: f32 logits scaled by
    D^-1/2, p = exp(l - rowmax) rounded to the input dtype, p v accumulated
    in f32, divided by the f32 row sum of the unrounded p, cast to the input
    dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    denom = p.sum(dim=-1).transpose(1, 2).unsqueeze(-1)  # [B, Sq, H, 1]
    return (o / denom).to(q.dtype)


def bind(lib):
    """Declare the C interface of a library built from csrc/flash_attention.cu."""
    fn = lib.reed_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.reed_flash_attention_info.argtypes = [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.reed_flash_attention_info.restype = ctypes.c_int
    lib.reed_cuda_error_string.argtypes = [ctypes.c_int]
    lib.reed_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _kernel():
    return bind(_build.load("flash_attention"))


def check_layout(shape, dtype, strides, data_ptrs):
    """Raise ValueError naming the cause unless the kernel takes q, k, v of
    this [B, S, H, D] shape and dtype with these strides (one tuple per
    tensor, in elements) and base addresses (bytes). Both kernels need the
    head dim contiguous and D <= 128. The bf16 kernel reads rows in 16-byte
    copies, so it also needs D % 8 == 0, 16-byte aligned base addresses and
    B, S, H strides that are multiples of 8 elements. The f32 kernel takes
    any such layout: it copies 16 bytes at a time where D % 4 == 0 and every
    base and stride allows, and 4 bytes at a time otherwise."""
    d = shape[-1]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel: head dim {d} > {_MAX_HEAD_DIM}")
    if any(st[-1] != 1 for st in strides):
        raise ValueError("flash attention kernel needs the head dim contiguous "
                         "(stride 1)")
    if dtype != torch.bfloat16:
        return
    if d % 8:
        raise ValueError(f"flash attention kernel (bf16): head dim {d} is not a "
                         "multiple of 8 (rows are read in 16-byte copies)")
    if any(p % 16 for p in data_ptrs):
        raise ValueError("flash attention kernel (bf16): a base address is not "
                         "16-byte aligned")
    if any(s % 8 for st in strides for s in st[:3]):
        raise ValueError("flash attention kernel (bf16): a batch, sequence or head "
                         f"stride is not a multiple of 8 elements (16 bytes): {strides}")


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash attention kernel: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError("flash attention kernel takes f32 or bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or (
            q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError("flash attention kernel takes q [B, Sq, H, D] and k, v "
                         f"[B, Sk, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    check_layout(q.shape, q.dtype, [t.stride() for t in (q, k, v)],
                 [t.data_ptr() for t in (q, k, v)])


def launch(q, k, v, lib=None):
    """Launch the kernel on the current stream and return o; counts
    nothing. `lib`: a library bound by `bind` (default: the built one)."""
    _check(q, k, v)
    lib = lib or _kernel()
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.reed_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, sq, k.shape[1], h, d, *strides, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.reed_cuda_error_string(err).decode())
    return o


def flash_attention_kernel(q, k, v):
    """Launch the CUDA kernel on the current stream: q [B, Sq, H, D] against
    k, v [B, Sk, H, D] -> [B, Sq, H, D]."""
    global launches
    o = launch(q, k, v)
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
        # a profiler range: a trace attributes the recompute's kernels to it
        with record_function("reed::flash_attention_bwd_recompute"), torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = sdpa_reference(q, k, v)
            return torch.autograd.grad(out, (q, k, v), g)


def flash_attention(q, k, v, mask=None):
    """q [B, Sq, H, D], k and v [B, Sk, H, D] -> [B, Sq, H, D].
    Differentiable. A masked call runs the plain version (SiT attention is
    unmasked)."""
    if mask is not None:
        return sdpa_reference(q, k, v, mask=mask)
    if q.is_cuda and not (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_kernel(q, k, v)  # no graph to record: skip autograd
    return _FlashAttention.apply(q, k, v)
