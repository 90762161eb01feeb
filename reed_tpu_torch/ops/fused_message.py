"""Fused k-NN message MLP: the hand-written CUDA kernels K2a (forward) and
K2b (backward) and their plain versions.

K2a replaces the TPU kernel `_fwd_kernel` (reed_tpu/ops/fused_message.py:132,
launched by `_fused_fwd_call`). For every edge (i, k) of a ProteinMPNN
k-NN graph:

    et  = e_feat[i,k] @ w_e + nbr_src[e_idx[i,k]]     (* mask in mode 'pre')
    msg = gelu(gelu(et + pre_self[i]) @ w2 + b2) @ w3 + b3   (* mask in 'post')

and returns dh = sum_k msg / scale and/or msg. K2b replaces `_bwd_kernel`
(reed_tpu/ops/fused_message.py:152, launched by `_fused_bwd`): it recomputes
the chain per tile and returns the gradients of pre_self, e_feat, nbr_src
and the five weights, as reed_tpu's custom VJP does from the saved inputs.
Both are `csrc/fused_message.cu`, one tensor-core tile engine for Hopper:
tiles of 64 edge rows (whole nodes, so the K-sum stays in the block), every
product on the tensor cores with mma.sync (f32 as three TF32 products a
piece, hi.hi + hi.lo + lo.hi, which keeps f32 accuracy; bf16 as one bf16
product), weights streamed through a cp.async ring. The backward's scatter
into nbr_src is an atomic add; its weight gradients are long TN products
of the operands the tile kernel writes, over fixed row ranges summed in a
fixed order. The measured times beside the bounds are in PERF.md
(chip_smoke.py).

A CUDA tensor launches the kernels or raises: `fused_message_mlp` is a
`torch.autograd.Function` whose forward is K2a and whose backward is K2b. A
CPU tensor runs `fused_message_reference`, the plain forward, with ordinary
autograd; `fused_message_backward_reference` is the plain backward, step by
step as K2b computes it, which the tests and chip_smoke.py hold K2b against.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from reed_tpu_torch import _build
from reed_tpu_torch.ops.graph import gather_nodes

# Kernel launches (K2a, K2b) since the count was last set to 0; a run reads
# them to show that it went through the kernels.
launches = 0
backward_launches = 0

MASK_MODES = {"none": 0, "pre": 1, "post": 2}
_MAX_D = 128   # one 128-column pass of a product's output (csrc/fused_message.cu)
_TILE_ROWS = 64  # edge rows of a tile: K may not exceed it


def fused_message_reference(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3,
                            b3, mask=None, mask_mode: str = "post",
                            scale: float = 30.0, want_sum: bool = True,
                            want_msg: bool = False):
    """Plain version of the kernel, the same function with the same rounding
    points: products in f32 on operands of the input dtype (m1 and m2 are
    rounded to it before their product), erf GELU in f32, outputs in
    e_feat's dtype. Returns (dh or None, msg or None)."""
    cdt = e_feat.dtype

    def rnd(x):  # operand rounding of bf16 inputs; a no-op in f32
        return x.to(cdt).float()

    et = e_feat.float() @ w_e.float() + gather_nodes(nbr_src, e_idx).float()
    if mask_mode == "pre":
        et = et * mask.float()[..., None]
    m1 = rnd(F.gelu(et + pre_self.float()[:, :, None, :]))
    m2 = rnd(F.gelu(m1 @ w2.float() + b2.float()))
    msg = m2 @ w3.float() + b3.float()
    if mask_mode == "post":
        msg = msg * mask.float()[..., None]
    dh = (msg.sum(dim=2) / scale).to(cdt) if want_sum else None
    return dh, (msg.to(cdt) if want_msg else None)


def _dgelu(x):
    """d/dx of the erf GELU: Phi(x) + x * phi(x)."""
    return (0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
            + x * 0.3989422804014327 * torch.exp(-0.5 * x * x))


def fused_message_backward_reference(pre_self, e_feat, nbr_src, e_idx, w_e, w2,
                                     b2, w3, b3, gdh, gmsg, mask=None,
                                     mask_mode: str = "post", scale: float = 30.0):
    """Plain version of the backward kernel, step by step as K2b (and the TPU
    `_bwd_kernel`) computes it: recompute pre, m1, z2, m2; then g3, g2, g1;
    then the input gradients and the five weight gradients. gdh [B,L,D]
    and/or gmsg [B,L,K,D] are the cotangents of dh and msg (None: zero).
    Products run in f32 on operands of the input dtype: g3, g2, ge, m1 and m2
    are rounded to it where they enter a product, while d pre_self, db2 and
    db3 sum the f32 values. An index outside [0, L) gathers and receives
    nothing. Returns (d pre_self, d e_feat, d nbr_src, d w_e, d w2, d b2,
    d w3, d b3), each in its input's dtype."""
    cdt = e_feat.dtype

    def rnd(x):
        return x.to(cdt).float()

    b, l, k, ce = e_feat.shape
    d = pre_self.shape[-1]
    valid = (e_idx >= 0) & (e_idx < l)
    idx = torch.where(valid, e_idx, 0).long()
    ef = e_feat.float()
    et = ef @ w_e.float() + gather_nodes(nbr_src, idx).float() * valid[..., None]
    m = mask.float()[..., None] if mask_mode != "none" else None
    if mask_mode == "pre":
        et = et * m
    pre = et + pre_self.float()[:, :, None, :]
    m1 = rnd(F.gelu(pre))
    z2 = m1 @ w2.float() + b2.float()
    m2 = rnd(F.gelu(z2))

    g3 = torch.zeros((b, l, k, d), dtype=torch.float32, device=e_feat.device)
    if gdh is not None:
        g3 = g3 + (gdh.float() / scale)[:, :, None, :]
    if gmsg is not None:
        g3 = g3 + gmsg.float()
    if mask_mode == "post":
        g3 = g3 * m
    g2 = (rnd(g3) @ w3.float().t()) * _dgelu(z2)
    g1 = (rnd(g2) @ w2.float().t()) * _dgelu(pre)
    d_pre_self = g1.sum(dim=2)
    ge = rnd(g1 * m if mask_mode == "pre" else g1)
    d_e_feat = ge @ w_e.float().t()
    rows = (torch.arange(b, device=e_feat.device)[:, None, None] * l + idx)[valid]
    d_nbr_src = torch.zeros((b * l, d), dtype=torch.float32, device=e_feat.device)
    d_nbr_src.index_add_(0, rows, ge[valid])

    def tn(x, y):  # x^T y over every edge row
        return x.reshape(-1, x.shape[-1]).t() @ y.reshape(-1, y.shape[-1])

    g2r, g3r = rnd(g2), rnd(g3)
    grads = (d_pre_self, d_e_feat, d_nbr_src.reshape(b, l, d), tn(ef, ge),
             tn(m1, g2r), g2.sum(dim=(0, 1, 2)), tn(m2, g3r), g3.sum(dim=(0, 1, 2)))
    like = (pre_self, e_feat, nbr_src, w_e, w2, b2, w3, b3)
    return tuple(g.to(t.dtype) for g, t in zip(grads, like))


def round_to_tf32(x):
    """x (f32) rounded to TF32 as the kernels' `cvt.rna.tf32.f32` does: to
    the nearest value with 10 mantissa bits, ties away from zero, returned
    as f32. The kernels split each f32 operand into hi = round_to_tf32(x)
    and lo = round_to_tf32(x - hi) and sum three tensor-core products (lo.hi
    + hi.lo + hi.hi); the tests emulate that with this helper to state the
    tolerance the f32 kernels are held to."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def bind(lib):
    """Declare the C interface of a library built from csrc/fused_message.cu."""
    fn = lib.reed_fused_message_fwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.reed_fused_message_bwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.reed_fused_message_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    fn = lib.reed_fused_message_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    lib.reed_cuda_error_string.argtypes = [ctypes.c_int]
    lib.reed_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _kernel():
    return bind(_build.load("fused_message"))


KERNEL_NAMES = ("fused_message_fwd_kernel", "fused_message_bwd_kernel",
                "fused_message_wgrad_kernel")


def kernel_info(dtype, which, lib=None):
    """(shared memory bytes of one block, blocks per SM, tile rows) of kernel
    KERNEL_NAMES[which] for dtype (f32 or bf16) on the current card."""
    lib = lib or _kernel()
    smem, blocks, rows = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.reed_fused_message_info(int(dtype == torch.bfloat16), int(which),
                                      ctypes.byref(smem), ctypes.byref(blocks),
                                      ctypes.byref(rows))
    if err:
        raise RuntimeError(lib.reed_cuda_error_string(err).decode())
    return smem.value, blocks.value, rows.value


def check_engine_shape(k, d, ce):
    """Raise ValueError naming the cause unless the tile engine takes K
    neighbours, width D and edge width Ce: D a multiple of 16 (bf16 products
    reduce 16 at a time) and at most 128 (one 128-column pass of output), Ce
    a multiple of 8 (rows are copied in 16-byte pieces) and K at most a
    tile's _TILE_ROWS = 64 edge rows (a node's K-sum stays in one block)."""
    if d > _MAX_D or d < 16 or d % 16:
        raise ValueError(f"fused message kernel: D = {d} must be a multiple of 16 "
                         f"in [16, {_MAX_D}]")
    if ce < 8 or ce % 8:
        raise ValueError(f"fused message kernel: Ce = {ce} must be a positive "
                         "multiple of 8 (16-byte copies)")
    if k < 1 or k > _TILE_ROWS:
        raise ValueError(f"fused message kernel: K = {k} must be in [1, "
                         f"{_TILE_ROWS}], the edge rows of a tile")


def _check_aligned(named):
    """The kernels copy rows in 16-byte pieces from each float tensor's base."""
    bad = [n for n, t in named.items() if t is not None and t.data_ptr() % 16]
    if bad:
        raise ValueError("fused message kernel: base address not 16-byte aligned: "
                         + ", ".join(bad))


def _check(pre_self, e_feat, nbr_src, e_idx, mask, weights):
    floats = (pre_self, e_feat, nbr_src) + weights
    tensors = floats + (e_idx,) + ((mask,) if mask is not None else ())
    if not all(t.is_cuda and t.device == e_feat.device for t in tensors):
        raise ValueError("fused message kernel: every tensor must be on one "
                         "CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if e_feat.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != e_feat.dtype for t in floats):
        raise ValueError("fused message kernel takes f32 or bf16 activations "
                         "and weights of one dtype, got "
                         + ", ".join(str(t.dtype) for t in floats))
    if e_feat.dim() != 4:
        raise ValueError(f"e_feat must be [B, L, K, Ce], got {tuple(e_feat.shape)}")
    b, l, k, ce = e_feat.shape
    d = pre_self.shape[-1]
    w_e, w2, b2, w3, b3 = weights
    want = {"pre_self": (b, l, d), "nbr_src": (b, l, d), "e_idx": (b, l, k),
            "w_e": (ce, d), "w2": (d, d), "b2": (d,), "w3": (d, d), "b3": (d,)}
    got = {"pre_self": pre_self, "nbr_src": nbr_src, "e_idx": e_idx, "w_e": w_e,
           "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    if mask is not None:
        want["mask"], got["mask"] = (b, l, k), mask
    bad = {n: tuple(got[n].shape) for n in want if tuple(got[n].shape) != want[n]}
    if bad:
        raise ValueError(f"fused message kernel: shapes {bad}, want "
                         f"{ {n: want[n] for n in bad} }")
    check_engine_shape(k, d, ce)


def launch(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3, mask=None,
           mask_mode: str = "post", scale: float = 30.0, want_sum: bool = True,
           want_msg: bool = False, lib=None):
    """Launch K2a on the current stream and return (dh or None, msg or
    None); counts nothing. `lib`: a library bound by `bind` (default: the
    built one). Inputs are made contiguous (a copy only for strided views,
    such as the weight slices of the first dense); e_idx is taken as int32
    and mask as f32."""
    weights = (w_e, w2, b2, w3, b3)
    _check(pre_self, e_feat, nbr_src, e_idx, mask, weights)
    lib = lib or _kernel()
    b, l, k, ce = e_feat.shape
    d = pre_self.shape[-1]
    args = [t.contiguous() for t in (pre_self, e_feat, nbr_src)]
    idx = e_idx.to(torch.int32).contiguous()
    m = mask.float().contiguous() if mask is not None else None
    ws = [t.contiguous() for t in weights]
    _check_aligned(dict(zip(("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3",
                             "b3"), args + ws)))
    dh = (torch.empty((b, l, d), dtype=e_feat.dtype, device=e_feat.device)
          if want_sum else None)
    msg = (torch.empty((b, l, k, d), dtype=e_feat.dtype, device=e_feat.device)
           if want_msg else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(e_feat.device):
        err = lib.reed_fused_message_fwd(
            *(ptr(t) for t in args), ptr(idx), ptr(m), *(ptr(t) for t in ws),
            ptr(dh), ptr(msg), int(e_feat.dtype == torch.bfloat16), b, l, k, d, ce,
            MASK_MODES[mask_mode], float(scale),
            torch.cuda.current_stream(e_feat.device).cuda_stream)
    if err:
        raise RuntimeError("fused message kernel launch failed: "
                           + lib.reed_cuda_error_string(err).decode())
    return dh, msg


def fused_message_kernel(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
                         mask=None, mask_mode: str = "post", scale: float = 30.0,
                         want_sum: bool = True, want_msg: bool = False):
    """Launch K2a on the current stream (see `launch`) and count it."""
    global launches
    out = launch(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3, mask=mask,
                 mask_mode=mask_mode, scale=scale, want_sum=want_sum, want_msg=want_msg)
    launches += 1
    return out


def launch_backward(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3, gdh, gmsg,
                    mask=None, mask_mode: str = "post", scale: float = 30.0, lib=None):
    """Launch K2b (and its fixed-order sum of the weight gradients) on the
    current stream; the arguments and results of
    `fused_message_backward_reference`; counts nothing. `lib`: a library
    bound by `bind` (default: the built one). d nbr_src is summed with atomic
    adds in f32, so its last bits vary from run to run; the weight gradients
    are the same on every run."""
    weights = (w_e, w2, b2, w3, b3)
    _check(pre_self, e_feat, nbr_src, e_idx, mask, weights)
    b, l, k, ce = e_feat.shape
    d = pre_self.shape[-1]
    cots = {"gdh": (gdh, (b, l, d)), "gmsg": (gmsg, (b, l, k, d))}
    for name, (g, shape) in cots.items():
        if g is not None and (not g.is_cuda or g.device != e_feat.device
                              or tuple(g.shape) != shape):
            raise ValueError(f"fused message backward: {name} must be a CUDA "
                             f"tensor of shape {shape} on {e_feat.device}")
    lib = lib or _kernel()
    dt, dev = e_feat.dtype, e_feat.device
    args = [t.contiguous() for t in (pre_self, e_feat, nbr_src)]
    idx = e_idx.to(torch.int32).contiguous()
    m = mask.float().contiguous() if mask is not None else None
    ws = [t.contiguous() for t in (w_e, w2, b2, w3)]
    gs = [g.to(dt).contiguous() if g is not None else None for g in (gdh, gmsg)]
    _check_aligned(dict(zip(("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3",
                             "gdh", "gmsg"), args + ws + gs)))
    n_w = ce * d + 2 * d * d + 2 * d
    d_pre_self = torch.empty((b, l, d), dtype=dt, device=dev)
    d_e_feat = torch.empty((b, l, k, ce), dtype=dt, device=dev)
    d_nbr_src = torch.zeros((b, l, d), dtype=torch.float32, device=dev)
    d_weights = torch.empty((n_w,), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    is_bf16 = int(dt == torch.bfloat16)
    with torch.cuda.device(dev):
        nbytes = ctypes.c_longlong(0)
        err = lib.reed_fused_message_bwd_workspace(is_bf16, b, l, k, d, ce,
                                                   ctypes.byref(nbytes))
        if not err:
            # the rounded product operands of the weight gradients and the
            # per-range and per-tile partial sums (the caching allocator
            # hands out 512-byte aligned blocks)
            workspace = torch.empty((max(nbytes.value, 1),), dtype=torch.uint8, device=dev)
            err = lib.reed_fused_message_bwd(
                *(ptr(t) for t in args), ptr(idx), ptr(m), *(ptr(t) for t in ws),
                *(ptr(g) for g in gs), ptr(d_pre_self), ptr(d_e_feat), ptr(d_nbr_src),
                ptr(d_weights), ptr(workspace), nbytes.value, is_bf16, b, l, k, d, ce,
                MASK_MODES[mask_mode], float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("fused message backward kernel launch failed: "
                           + lib.reed_cuda_error_string(err).decode())
    d_we, d_w2, d_b2, d_w3, d_b3 = torch.split(d_weights, [ce * d, d * d, d, d * d, d])
    return (d_pre_self, d_e_feat, d_nbr_src.to(nbr_src.dtype),
            d_we.view(ce, d).to(w_e.dtype), d_w2.view(d, d).to(w2.dtype),
            d_b2.to(b2.dtype), d_w3.view(d, d).to(w3.dtype), d_b3.to(b3.dtype))


def fused_message_backward_kernel(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2,
                                  w3, b3, gdh, gmsg, mask=None,
                                  mask_mode: str = "post", scale: float = 30.0):
    """Launch K2b on the current stream (see `launch_backward`) and count it."""
    global backward_launches
    out = launch_backward(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3, gdh,
                          gmsg, mask=mask, mask_mode=mask_mode, scale=scale)
    backward_launches += 1
    return out


class _FusedMessage(torch.autograd.Function):
    """K2a forward, K2b backward. Like reed_tpu's custom VJP it saves the
    inputs, not the intermediates: the backward recomputes the chain."""

    @staticmethod
    def forward(ctx, pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
                mask, mask_mode, scale, want_sum, want_msg):
        dh, msg = fused_message_kernel(pre_self, e_feat, nbr_src, e_idx, w_e, w2,
                                       b2, w3, b3, mask=mask, mask_mode=mask_mode,
                                       scale=scale, want_sum=want_sum,
                                       want_msg=want_msg)
        ctx.save_for_backward(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
                              mask)
        ctx.flags = (mask_mode, scale, want_sum, want_msg)
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return tuple(t for t in (dh, msg) if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        mask_mode, scale, want_sum, want_msg = ctx.flags
        grads = iter(grads)
        gdh = next(grads) if want_sum else None
        gmsg = next(grads) if want_msg else None
        nones = (None,) * 5  # mask and the four flags
        if gdh is None and gmsg is None:
            return (None,) * 9 + nones
        (pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
         mask) = ctx.saved_tensors
        (d_ps, d_ef, d_ns, d_we, d_w2, d_b2, d_w3, d_b3) = fused_message_backward_kernel(
            pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3, gdh, gmsg,
            mask=mask, mask_mode=mask_mode, scale=scale)
        return (d_ps, d_ef, d_ns, None, d_we, d_w2, d_b2, d_w3, d_b3) + nones


def fused_message_mlp(pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3,
                      mask=None, mask_mode: str = "post", scale: float = 30.0,
                      want_sum: bool = True, want_msg: bool = False):
    """Fused k-NN message MLP (signature of reed_tpu's, without its block
    sizes and interpret flag).

    pre_self [B,L,D] (self term incl. the first dense's bias), e_feat
    [B,L,K,Ce], nbr_src [B,L,D] (gathered by e_idx [B,L,K]), w_e [Ce,D],
    w2/w3 [D,D] and b2/b3 [D] (flax layout: [in, out]), optional mask
    [B,L,K] applied 'pre' (DecLayer) or 'post' (EncLayer); no mask means
    mode 'none'. Returns (dh, msg): dh = sum_k msg / scale when want_sum,
    the [B,L,K,D] message when want_msg; None otherwise."""
    if not (want_sum or want_msg):
        raise ValueError("fused_message_mlp: ask for want_sum and/or want_msg")
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode must be one of {sorted(MASK_MODES)}, "
                         f"got {mask_mode!r}")
    if mask is None:
        mask_mode = "none"
    args = (pre_self, e_feat, nbr_src, e_idx, w_e, w2, b2, w3, b3)
    if e_feat.device.type == "cpu":
        return fused_message_reference(*args, mask=mask, mask_mode=mask_mode,
                                       scale=scale, want_sum=want_sum,
                                       want_msg=want_msg)
    outs = iter(_FusedMessage.apply(*args, mask, mask_mode, scale, want_sum,
                                    want_msg))
    dh = next(outs) if want_sum else None
    msg = next(outs) if want_msg else None
    return dh, msg
