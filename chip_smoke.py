"""Chip smoke test of the PyTorch/CUDA port (reed_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result):
  1. device: a CUDA device is required; prints its name and power limit.
  2. build: every kernel under reed_tpu_torch/csrc/, one nvcc each, together;
     ptxas registers, stack and spills of each kernel.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main paths give it (and a few more), with stated
     tolerances; kernel, plain and library (yardstick only) times, taken in
     turns, and the least time the card could take for the same work
     (bound_ms; f32 at the 3xTF32 tensor-core rate, with bound_ms_67 at the
     CUDA-core rate beside it). K1 in bf16 also on SiT's strided q/k/v
     views of one [B, S, 3, H, D] tensor; each kernel's shared memory and
     blocks per SM; K2b's weight gradients bitwise equal over two launches.
  4. image slice: SiT-XL/2 at full width with seeded N(0, 0.02) weights
     (nonzero adaLN and final layer, so attention reaches the output): one
     model call through the kernel against the same call with plain
     attention, in f32 and bf16; times and a torch.profiler breakdown of a
     bf16 model call; then its main path, `generate_samples`
     (SDE with CFG inside a guidance window), with every kernel's launch
     count set to 0 just before it and read just after, and its samples
     against a run with plain attention.
  5. protein slice: ProteinMPNN-FMIF at full width (the default
     ProteinTrainConfig) with seeded weights (nonzero node_embeds and
     LayerNorms): one forward with the message chains through the kernel
     against the unfused layer math, in f32 and bf16; then its main path,
     `sample` (Euler unmasking, 50 steps, encoder hoisted) on a synthetic
     batch of 8 x 256 residues, with the launch counts set to 0 just before
     it and read just after, and its tokens against a run with the unfused
     chain from the same generator seed.
  6. protein training: the default ProteinTrainConfig at full width with the
     denoising loss on from step 0 and a synthetic batch of 8 x 256 with AF3-
     style embeddings. One step (dropout 0, the same corrupted tokens) with
     the message chains through K2a/K2b against the unfused layer math:
     metrics and every parameter's gradient. Then the main path,
     `ProteinTrainer.train_step` (dropout 0.1), with the launch counts set to
     0 just before its timed steps and read just after (9 K2a + 9 K2b per
     step), ms per step and residues/s, a torch.profiler breakdown of one
     step; a learning check on the convergence gate's rule data (its CE
     must fall as the JAX run's did); and `train-protein --steps 3
     --synthetic` through the CLI.
  7. output: a {"kernels": [...]} line, the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.

K2b (the backward kernel) is held against its plain backward in phase 3.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from reed_tpu_torch import _build, cli
from reed_tpu_torch.core.config import CurriculumConfig
from reed_tpu_torch.core.trainer import combine_losses
from reed_tpu_torch.diffusion.discrete import corrupt_batch
from reed_tpu_torch.eval.fid import FIDGenConfig, generate_samples
from reed_tpu_torch.models.sit import create_sit
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.ops import fused_message as fm
from reed_tpu_torch.tools.convergence_protein import gate_config, rule_batch
from reed_tpu_torch.tools.cuda_timing import cuda_ms, host_us, timed_in_turns
from reed_tpu_torch.train.protein import (ProteinTrainConfig, ProteinTrainer,
                                          build_model, make_loss_fn, sample,
                                          synthetic_protein_batch)

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input
# type. f32: the least time the card can take for f32-accurate products is
# on the tensor cores as 3xTF32, three TF32 products a piece (hi.hi + hi.lo
# + lo.hi, which keeps f32 accuracy) at 495 TFLOP/s, so 495 / 3; the f32
# fused message kernels run so. The same work has the same bound whatever
# implements it, so K1's f32 bound is taken at that rate too. The bound at
# the f32 rate outside the tensor cores (67 TFLOP/s) is reported beside it
# as bound_ms_67.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
F32_CUDA_CORES_FLOPS = 67e12
# K1's plain version by dtype: in bf16 the one at the kernel's rounding
# points (p rounded to bf16 before the PV product, as the TPU kernel does);
# in f32 plain attention (the same function: nothing is rounded)
ATTN_PLAIN = {torch.float32: fa.sdpa_reference, torch.bfloat16: fa.flash_attention_reference}
# kernel vs plain version, max abs error on N(0, 1) inputs. f32: both
# accumulate in f32, only the summation order differs. bf16: both round p
# to bf16 and sum p v in f32, but the kernel rounds exp(l - running max)
# and rescales it in f32 when the max moves, and sums in another order, so
# a p or an output can round the other way: about 1 bf16 ulp of outputs up
# to |2| (2^-7 on [1, 2)).
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# full SiT-XL/2 call, kernel vs plain attention, max abs error relative to
# the output's max: f32 differs by summation order only; in bf16 the
# attention outputs differ by ~1 ulp and that propagates through 28 blocks
SIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# generated latents after 8 SDE steps, kernel vs plain attention (bf16)
GEN_RTOL = 5e-2

MAIN_SHAPE = (16, 256, 16, 72)  # SiT-XL/2, batch 8 doubled by CFG
ATTN_SHAPES = [
    MAIN_SHAPE,
    (8, 256, 16, 72),   # SiT-XL/2 outside the guidance window
    (8, 64, 6, 64),     # SiT-S/4
    (4, 1024, 16, 72),  # SiT-XL/2 at 512 px
    (2, 200, 4, 72),    # ragged S
]
DEPTH = 28
GEN = dict(num_samples=16, batch_size=8, mode="sde", num_steps=8,
           cfg_scale=4.0, guidance_low=0.0, guidance_high=0.5, seed=0)

# fused message kernel vs its plain version, max abs error on inputs whose
# activations are O(1). f32: both accumulate in f32; the kernel's products
# are 3xTF32 (~6e-7 relative, tests/test_torch_fused_message_tf32.py) and
# the summation order differs. bf16: both round m1, m2 and the output to
# bf16 at the same points, so they differ where an f32 summation-order
# difference flips a rounding: one bf16 ulp of an output (2^-7 on [1, 2),
# 2^-6 on [2, 4)).
MSG_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# (B, L, K, D, Ce), mask mode, outputs
MSG_CASES = [
    ((8, 256, 30, 128, 128), "post", "sum"),   # EncLayer chain 1
    ((8, 256, 30, 128, 128), "none", "msg"),   # EncLayer chain 2
    ((8, 256, 30, 128, 256), "pre", "both"),   # DecLayer, 147 of 153 launches
    ((3, 100, 30, 128, 256), "pre", "both"),   # ragged L
    ((2, 16, 4, 32, 64), "post", "both"),      # narrow
]
MSG_MAIN = MSG_CASES[2]
# ProteinMPNN-FMIF log-probs, message chains through the kernel vs the
# unfused layer math, max abs error over valid positions. f32: summation
# order only, through 3 + 3 layers. bf16: the unfused math rounds each
# product's output to bf16 where the kernel keeps f32 until m1, m2 and msg
# are rounded, so messages differ by ~1 bf16 ulp, carried through 6 layers
# and 6 LayerNorms into log-probs of magnitude ~3.
PMPNN_ATOL = {torch.float32: 2e-4, torch.bfloat16: 0.25}
PROTEIN = dict(batch=8, length=256, num_steps=50)
# 50-step sampling, kernel vs unfused chain with one generator seed: at
# least this share of tokens equal (f32). A near-tie flip changes later
# draws; a broken kernel lands near chance (1/20).
TOKEN_AGREEMENT = 0.9
# one full-width train step (dropout 0, the same corrupted tokens), message
# chains through K2a/K2b vs the unfused layer math: each metric to 1e-4
# (relative above 1, absolute below: the alignment losses are near 0 at
# init), each parameter's gradient to 1e-3 of that gradient's max. Both
# are f32; the sums run in another order (K2b's fixed row ranges and
# atomic adds against cuBLAS and PyTorch's reductions) through 3 + 3 layers.
TRAIN_METRIC_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN = dict(batch=8, length=256, timed_steps=20)
# learning check on the convergence gate's data (16 x 48, rule batches of
# tools/convergence_protein.py): the JAX run on a TPU went from CE 1.50 at
# step 0 to 1.16 at step 100 and 1.17 at step 200 (CONVERGENCE_PROTEIN.json).
# The mean CE of steps 180-199 must be below LEARN_CE_MAX, which a model that
# does not learn (CE stays ~1.5) cannot reach.
LEARN_STEPS = 200
LEARN_CE_MAX = 1.30


def log(*args):
    print(*args, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def demangle(symbol):
    try:
        name = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return symbol
    return name.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]


def build_phase():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():  # ptxas -v: one entry function at a time
        entry, stack = None, ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = demangle(line.split("'")[1])
            elif "spill" in line:
                stack = line.strip()
            elif "registers" in line:
                log(f"[build] {name}: {entry}: {line.split(':', 1)[-1].strip()}; {stack}")


def roofline(nbytes, flops, dtype):
    """(bound_ms, bound_by, bound_ms_67): the least time for moving nbytes
    and doing flops of dtype, what bounds it, and in f32 the same bound at
    the CUDA-core rate (None in bf16)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    ms_67 = (max(t_bytes, flops / F32_CUDA_CORES_FLOPS) * 1e3
             if dtype == torch.float32 else None)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", ms_67


def attention_bound(shape, dtype):
    b, s, h, d = shape
    nbytes = 4 * b * s * h * d * torch.finfo(dtype).bits // 8  # q, k, v, o
    return roofline(nbytes, 4 * b * h * s * s * d, dtype)


def attention_info():
    """Dynamic shared memory per block and blocks per SM of the kernels at
    the checked head dims."""
    lib = fa._kernel()
    for dtype in (torch.bfloat16, torch.float32):
        for d in sorted({shape[-1] for shape in ATTN_SHAPES}):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = lib.reed_flash_attention_info(int(dtype == torch.bfloat16), d,
                                                ctypes.byref(smem), ctypes.byref(blocks))
            if err:
                raise RuntimeError(lib.reed_cuda_error_string(err).decode())
            log(f"[kernel] flash_attention {str(dtype)[6:]} D {d}: {smem.value} bytes "
                f"of shared memory per block, {blocks.value} blocks per SM")


def attention_case(label, q, k, v, smi):
    dtype = q.dtype
    plain = ATTN_PLAIN[dtype]
    out = fa.flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    ref = plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    times = timed_in_turns({
        "ms": lambda: fa.flash_attention_kernel(q, k, v),
        "plain_ms": lambda: plain(q, k, v),
        "library_ms": lambda: F.scaled_dot_product_attention(qt, kt, vt)})
    bound, bound_by, bound_67 = attention_bound(tuple(q.shape), dtype)
    row = dict(max_abs_err=err, atol=ATTN_ATOL[dtype],
               max_abs_ref=ref.float().abs().max().item(), **times,
               bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67)
    log(f"[kernel] flash_attention {label} {str(dtype)[6:]} vs {plain.__name__} "
        f"({smi}): " + json.dumps(row))
    if not (torch.isfinite(out).all() and err <= ATTN_ATOL[dtype]):
        raise AssertionError(f"flash_attention {label} {dtype}: max abs err "
                             f"{err} > {ATTN_ATOL[dtype]}")
    return row


def kernel_phase(smi):
    attention_info()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                       for _ in range(3))
            rows[(shape, dtype)] = attention_case(str(shape), q, k, v, smi)
    # SiT's layout: q, k, v strided views of the fused projection, no copy
    b, s, h, d = MAIN_SHAPE
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    attention_case(f"{MAIN_SHAPE} qkv[:, :, i] views", q, k, v, smi)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    log("[kernel] flash_attention host time per call (launch cost, us): " + json.dumps({
        "flash_attention_kernel": host_us(lambda: fa.flash_attention_kernel(q, k, v)),
        "flash_attention, no grad": host_us(lambda: fa.flash_attention(q, k, v)),
        "SDPA": host_us(lambda: F.scaled_dot_product_attention(qt, kt, vt))}))
    # backward: autograd.Function (kernel forward, plain recompute) vs plain
    q, k, v = (torch.randn((2, 64, 4, 72), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    g_kernel = torch.autograd.grad(fa.flash_attention(q, k, v).square().sum(), (q, k, v))
    g_plain = torch.autograd.grad(fa.sdpa_reference(q, k, v).square().sum(), (q, k, v))
    gerr = max((a - b).abs().max().item() for a, b in zip(g_kernel, g_plain))
    log(f"[kernel] flash_attention backward max abs err {gerr:.3g} (atol 1e-4)")
    if not gerr <= 1e-4:
        raise AssertionError(f"flash_attention backward err {gerr}")
    return rows


def message_bound(case, dtype):
    """Least time for one fused message launch: inputs read once (with
    int32 e_idx and f32 mask) and outputs written once over the memory
    rate, or the three products' flops over the peak for dtype."""
    (b, l, k, d, ce), mode, outputs = case
    es = torch.finfo(dtype).bits // 8
    e = b * l * k
    nbytes = (es * (2 * b * l * d + e * ce + ce * d + 2 * d * d + 2 * d) + 4 * e
              + (4 * e if mode != "none" else 0)
              + es * (b * l * d * (outputs != "msg") + e * d * (outputs != "sum")))
    return roofline(nbytes, 2 * e * (ce * d + 2 * d * d), dtype)


def message_inputs(case, dtype, gen):
    """Kernel arguments with O(1) activations (weights ~ N(0, 1/fan_in))."""
    (b, l, k, d, ce), mode, outputs = case

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    mask = (torch.rand((b, l, k), generator=gen, device="cuda") < 0.8).float()
    return dict(
        pre_self=randn(b, l, d, std=0.5), e_feat=randn(b, l, k, ce),
        nbr_src=randn(b, l, d, std=0.5),
        e_idx=torch.randint(0, l, (b, l, k), generator=gen, device="cuda",
                            dtype=torch.int32),
        w_e=randn(ce, d, std=ce ** -0.5), w2=randn(d, d, std=d ** -0.5),
        b2=randn(d, std=0.1), w3=randn(d, d, std=d ** -0.5), b3=randn(d, std=0.1),
        mask=None if mode == "none" else mask, mask_mode=mode,
        want_sum=outputs != "msg", want_msg=outputs != "sum")


def message_info():
    """Shared memory per block, blocks per SM and tile rows of the fused
    message kernels (K2a; K2b's tile kernel and weight-gradient kernel)."""
    for dtype in (torch.float32, torch.bfloat16):
        for which, name in enumerate(fm.KERNEL_NAMES):
            smem, blocks, rows = fm.kernel_info(dtype, which)
            log(f"[kernel] {name} {str(dtype)[6:]}: {smem} bytes of shared memory per "
                f"block, {blocks} blocks per SM, {rows}-row tiles")


def message_kernel_phase(smi):
    message_info()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for case in MSG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            kw = message_inputs(case, dtype, gen)
            out = fm.fused_message_kernel(**kw)
            torch.cuda.synchronize()
            ref = fm.fused_message_reference(**kw)
            err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(out, ref) if r is not None)
            ref_max = max(r.float().abs().max().item() for r in ref if r is not None)
            bound, bound_by, bound_67 = message_bound(case, dtype)
            times = timed_in_turns({
                "ms": lambda: fm.fused_message_kernel(**kw),
                "plain_ms": lambda: fm.fused_message_reference(**kw)})
            row = dict(max_abs_err=err, atol=MSG_ATOL[dtype], max_abs_ref=ref_max, **times,
                       bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67,
                       library_ms=None)
            rows[(case, dtype)] = row
            log(f"[kernel] fused_message {case[0]} {case[1]}/{case[2]} "
                f"{str(dtype)[6:]} ({smi}): " + json.dumps(row))
            if not err <= MSG_ATOL[dtype]:
                raise AssertionError(f"fused_message {case} {dtype}: max abs err "
                                     f"{err} > {MSG_ATOL[dtype]}")
    return rows


# backward kernel vs its plain backward, max abs error of each of the eight
# gradients relative to that gradient's max. f32: the kernel's products are
# 3xTF32 (~6e-7 relative a product, tests/test_torch_fused_message_tf32.py)
# and the summation order differs (the weight gradients sum 61,440 edge rows
# in fixed row ranges; d nbr_src takes atomic adds in no fixed order). bf16:
# both round g3, g2 and ge to bf16 at the same points, so a summation-order
# difference that flips one rounding moves that element by one bf16 ulp
# (2^-8 relative), which reaches the products it feeds.
MSG_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
GRAD_NAMES = ("d_pre_self", "d_e_feat", "d_nbr_src", "d_w_e", "d_w2", "d_b2",
              "d_w3", "d_b3")


def message_backward_bound(case, dtype):
    """Least time for one backward launch: inputs, cotangents and the eight
    gradients moved once over the memory rate, or 2*E*(3*Ce*D + 5*D*D) flops
    (two recomputed products and five backward ones) over the peak."""
    (b, l, k, d, ce), mode, outputs = case
    es = torch.finfo(dtype).bits // 8
    e = b * l * k
    n_w = ce * d + 2 * d * d + 2 * d
    inputs = es * (2 * b * l * d + e * ce + n_w) + 4 * e + (4 * e if mode != "none" else 0)
    cots = es * (b * l * d * (outputs != "msg") + e * d * (outputs != "sum"))
    grads = es * (2 * b * l * d + e * ce + n_w)
    return roofline(inputs + cots + grads, 2 * e * (3 * ce * d + 5 * d * d), dtype)


def message_backward_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for case in MSG_CASES:
        (b, l, k, d, ce), _, _ = case
        for dtype in (torch.float32, torch.bfloat16):
            kw = message_inputs(case, dtype, gen)
            want_sum, want_msg = kw.pop("want_sum"), kw.pop("want_msg")
            kw["gdh"] = (torch.randn((b, l, d), generator=gen, device="cuda").to(dtype)
                         if want_sum else None)
            kw["gmsg"] = (torch.randn((b, l, k, d), generator=gen, device="cuda").to(dtype)
                          if want_msg else None)
            out = fm.fused_message_backward_kernel(**kw)
            again = fm.fused_message_backward_kernel(**kw)
            torch.cuda.synchronize()
            ref = fm.fused_message_backward_reference(**kw)
            rel = {n: ((a.float() - r.float()).abs().max()
                       / r.float().abs().max().clamp_min(1e-30)).item()
                   for n, a, r in zip(GRAD_NAMES, out, ref)}
            finite = all(bool(torch.isfinite(a).all()) for a in out)
            # the weight gradients are summed in a fixed order: equal bits on every run
            same = all(torch.equal(a, b) for a, b in zip(out[3:], again[3:]))
            bound, bound_by, bound_67 = message_backward_bound(case, dtype)
            times = timed_in_turns({
                "ms": lambda: fm.fused_message_backward_kernel(**kw),
                "plain_ms": lambda: fm.fused_message_backward_reference(**kw)})
            row = dict(max_rel_err=max(rel.values()), rtol=MSG_BWD_RTOL[dtype],
                       max_abs_err=max((a.float() - r.float()).abs().max().item()
                                       for a, r in zip(out, ref)),
                       rel_err=rel, weight_grads_bitwise_equal_over_two_launches=same,
                       **times, bound_ms=bound, bound_by=bound_by, bound_ms_67=bound_67,
                       library_ms=None)
            rows[(case, dtype)] = row
            log(f"[kernel] fused_message_bwd {case[0]} {case[1]}/{case[2]} "
                f"{str(dtype)[6:]} ({smi}): " + json.dumps(row))
            if not (finite and same and row["max_rel_err"] <= MSG_BWD_RTOL[dtype]):
                raise AssertionError(f"fused_message_bwd {case} {dtype}: relative "
                                     f"errors {rel} (rtol {MSG_BWD_RTOL[dtype]}), "
                                     f"finite {finite}, weight gradients equal over "
                                     f"two launches {same}")
    # autograd: kernel forward + kernel backward against plain autograd
    case = MSG_CASES[2]
    kw = message_inputs(case, torch.float32, gen)
    names = ("pre_self", "e_feat", "nbr_src", "w_e", "w2", "b2", "w3", "b3")
    leaves = {n: kw[n].clone().requires_grad_() for n in names}
    cot = [torch.randn(t.shape, generator=gen, device="cuda")
           for t in fm.fused_message_reference(**kw)]
    before = (fm.launches, fm.backward_launches)
    got = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(fm.fused_message_mlp(**{**kw, **leaves}), cot)),
        [leaves[n] for n in names])
    counted = (fm.launches - before[0], fm.backward_launches - before[1])
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(fm.fused_message_reference(**{**kw, **leaves}), cot)),
        [leaves[n] for n in names])
    rel = max(((a - r).abs().max() / r.abs().max()).item() for a, r in zip(got, want))
    log(f"[kernel] fused_message_mlp autograd (K2a + K2b) vs plain autograd at "
        f"{case[0]}: max rel err {rel:.3g} (rtol {MSG_BWD_RTOL[torch.float32]}), "
        f"launches fwd/bwd {counted}")
    if not (rel <= MSG_BWD_RTOL[torch.float32] and counted == (1, 1)):
        raise AssertionError(f"fused_message_mlp autograd: rel err {rel}, launches {counted}")
    return rows


# kernel families of the profile summary, matched in order on kernel names
PROFILE_GROUPS = (("K2b fused_message_bwd", ("fused_message_bwd", "fused_message_wgrad",
                                             "sum_grads", "sum_bias")),
                  ("K2a fused_message_fwd", ("fused_message_fwd",)),
                  ("K1 flash_attention", ("attention_fwd",)),
                  ("GEMM (cuBLAS/CUTLASS)", ("gemm", "Kernel2", "nvjet")),
                  ("LayerNorm fwd/bwd", ("layer_norm", "GammaBeta")),
                  ("reductions", ("reduce_kernel",)),
                  ("elementwise, copies, other", ("",)))


def profile(label, fn, smi, top=8):
    """Device time of one call by kernel (torch.profiler, CUPTI): the busy
    share of the call's wall time, the time of each kernel family and the
    kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), {len(kernels)} kernel "
        f"names, {sum(e.count for e in kernels)} launches ({smi})")
    groups = dict.fromkeys(name for name, _ in PROFILE_GROUPS)
    for e in kernels:
        name = next(n for n, keys in PROFILE_GROUPS if any(k in e.key for k in keys))
        ms, count = groups[name] or (0.0, 0)
        groups[name] = (ms + e.self_device_time_total / 1e3, count + e.count)
    log(f"[profile]   by family: " + "; ".join(
        f"{n} {v[0]:.3f} ms x{v[1]}" for n, v in groups.items() if v))
    for e in kernels[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:110]}")


def perturb_pmpnn(model, gen):
    """Seeded nonzero node_embeds and LayerNorms on top of the initialisation
    (zero node_embeds and unit LayerNorms would hide the encoder's start)."""
    with torch.no_grad():
        model.node_embeds.normal_(0.0, 1.0, generator=gen)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.add_(torch.randn(m.weight.shape, generator=gen,
                                          device="cuda") * 0.1)
                m.bias.normal_(0.0, 0.1, generator=gen)


@torch.no_grad()
def protein_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = ProteinTrainConfig()
    model = build_model(cfg, device="cuda", generator=gen)
    perturb_pmpnn(model, gen)
    batch = synthetic_protein_batch(gen, PROTEIN["batch"], PROTEIN["length"])
    args = (batch["X"], batch["S"], batch["mask"], batch["chain_M"],
            batch["residue_idx"], batch["chain_encoding_all"])
    for dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model).to_compute_dtype(dtype)
        m.fused = True
        out = m(*args)
        m.fused = False
        ref = m(*args)
        err = (out - ref).abs().max().item()
        log(f"[protein] ProteinMPNN-FMIF {str(dtype)[6:]} forward, kernel vs "
            f"unfused chain: log-probs max abs err {err:.3g} (atol "
            f"{PMPNN_ATOL[dtype]}), max |log p| {ref.abs().max().item():.3g}")
        if not (torch.isfinite(out).all() and err <= PMPNN_ATOL[dtype]):
            raise AssertionError(f"ProteinMPNN-FMIF {dtype}: err {err}")
        del m

    if not (model.fused and model.dtype == torch.float32):
        raise AssertionError("the default config must run the kernel in f32")
    enc = model(*args, return_enc=True)
    enc_ms = cuda_ms(lambda: model(*args, return_enc=True), iters=10, warmup=2,
                     queued=False)
    dec_ms = cuda_ms(lambda: model(*args, enc_state=enc), iters=20, warmup=2, queued=False)
    log(f"[protein] f32 encoder pass {enc_ms:.3f} ms, decoder step {dec_ms:.3f} ms "
        f"at batch {PROTEIN['batch']} x {PROTEIN['length']} ({smi})")
    profile("encoder pass", lambda: model(*args, return_enc=True), smi)
    profile("decoder step", lambda: model(*args, enc_state=enc), smi)

    interp = dataclasses.replace(cfg.interpolant, num_timesteps=PROTEIN["num_steps"])
    torch.cuda.synchronize()
    fm.launches = fa.launches = 0
    t0 = time.perf_counter()
    pred, tokens = sample(model, batch, torch.Generator(device="cuda").manual_seed(7),
                          interp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fm.launches
    expect = 2 * cfg.num_encoder_layers + cfg.num_decoder_layers * (interp.num_timesteps - 1)
    n = PROTEIN["batch"]
    log(f"[protein] sample: {n} x {PROTEIN['length']} residues, "
        f"{interp.num_timesteps} steps, {launches} fused_message launches "
        f"(expected {expect}), {fa.launches} flash_attention, {seconds:.4f} s: "
        f"{n / seconds:.3f} sequences/s, {n * PROTEIN['length'] / seconds:.1f} "
        f"residues/s, {1e3 * seconds / (interp.num_timesteps - 1):.3f} ms per "
        f"decoder step incl. the encoder pass ({smi})")
    valid = batch["mask"].bool()
    if launches != expect:
        raise AssertionError(f"expected {expect} fused_message launches, got {launches}")
    if (tokens[valid] == interp.mask_index).any() or (pred[valid] == interp.mask_index).any():
        raise AssertionError("mask tokens left at valid positions after sampling")

    model.fused = False
    pred_p, tokens_p = sample(model, batch,
                              torch.Generator(device="cuda").manual_seed(7), interp)
    model.fused = True
    agree = (tokens_p == tokens)[valid].float().mean().item()
    agree_pred = (pred_p == pred)[valid].float().mean().item()
    log(f"[protein] sampled tokens, kernel vs unfused chain: {agree:.4f} equal "
        f"(pred {agree_pred:.4f}; at least {TOKEN_AGREEMENT})")
    if not agree >= TOKEN_AGREEMENT:
        raise AssertionError(f"token agreement {agree} < {TOKEN_AGREEMENT}")
    profile(f"sample ({interp.num_timesteps} steps)", lambda: sample(
        model, batch, torch.Generator(device="cuda").manual_seed(7), interp), smi)
    return launches


def train_config(dropout=0.1):
    """The default ProteinTrainConfig with the denoising loss weighted 1 from
    step 0 (its default warm-up gives it weight 0 at step 0)."""
    cfg = ProteinTrainConfig(dropout=dropout)
    return dataclasses.replace(cfg, curriculum=dataclasses.replace(
        cfg.curriculum, diffusion_warmup_steps=0))


def train_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(3)

    # one step, message chains through the kernels vs the unfused chain
    cfg = train_config(dropout=0.0)
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    perturb_pmpnn(state.model, gen)
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    corrupted = corrupt_batch(batch, cfg.interpolant, gen)
    noisy = (corrupted["S_t"], corrupted["t"])
    loss_fn = make_loss_fn(cfg)
    names, params = zip(*state.model.named_parameters())
    results = {}
    for fused in (True, False):
        state.model.fused = fused
        before = (fm.launches, fm.backward_launches)
        metrics = loss_fn(state.model, batch, 0, noisy=noisy)
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        torch.cuda.synchronize()
        counted = (fm.launches - before[0], fm.backward_launches - before[1])
        results[fused] = ({k: v.item() for k, v in dict(metrics, loss=total).items()},
                          [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, params)], counted)
    state.model.fused = True
    (m_f, g_f, n_f), (m_u, g_u, _) = results[True], results[False]
    metric_err = max(abs(m_f[k] - m_u[k]) / max(abs(m_u[k]), 1.0) for k in m_u)
    grad_err = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for n, a, b in zip(names, g_f, g_u)}
    worst = max(grad_err, key=grad_err.get)
    per_step = 2 * trainer.cfg.num_encoder_layers + trainer.cfg.num_decoder_layers
    log(f"[train] one step at {TRAIN['batch']} x {TRAIN['length']}, kernels vs unfused "
        f"chain: metrics max rel err {metric_err:.3g} (rtol {TRAIN_METRIC_RTOL}), "
        f"gradients max err / max |g| {grad_err[worst]:.3g} at {worst} (rtol "
        f"{TRAIN_GRAD_RTOL}) over {len(names)} parameters; launches fwd/bwd {n_f}; "
        f"loss {m_f['loss']:.6g}, denoising {m_f['denoising_loss']:.6g}, proj "
        f"{m_f['proj_loss']:.6g}")
    if not (metric_err <= TRAIN_METRIC_RTOL and grad_err[worst] <= TRAIN_GRAD_RTOL
            and all(torch.isfinite(g).all() for g in g_f)):
        raise AssertionError(f"fused vs unfused train step: metrics {m_f} vs {m_u}, "
                             f"gradient errors {grad_err}")
    if n_f != (per_step, per_step):
        raise AssertionError(f"expected {per_step} K2a and K2b launches, got {n_f}")
    del trainer, state, results, g_f, g_u, grads

    # the main path: ProteinTrainer.train_step at the default dropout
    cfg = train_config()
    trainer = ProteinTrainer(cfg, device="cuda")
    state = trainer.init_state()
    batch = trainer.synthetic_batch(gen, TRAIN["batch"], TRAIN["length"])
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    steps = TRAIN["timed_steps"]
    fm.launches = fm.backward_launches = fa.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (fm.launches, fm.backward_launches)
    residues = TRAIN["batch"] * TRAIN["length"]
    log(f"[train] ProteinTrainer.train_step, default config (dropout "
        f"{cfg.dropout}): {steps} steps in {seconds:.4f} s = "
        f"{1e3 * seconds / steps:.3f} ms per step, {residues * steps / seconds:.1f} "
        f"residues/s, {TRAIN['batch'] * steps / seconds:.2f} sequences/s; launches "
        f"K2a {launches[0]}, K2b {launches[1]} (expected {per_step * steps} each), "
        f"flash_attention {fa.launches}; last loss {metrics['loss'].item():.6g}, "
        f"grad_norm {metrics['grad_norm'].item():.4g} ({smi})")
    if launches != (per_step * steps, per_step * steps):
        raise AssertionError(f"expected {per_step * steps} K2a and K2b launches, "
                             f"got {launches}")
    if not all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics {metrics}")
    profile("train step", lambda: trainer.train_step(state, batch), smi, top=12)
    del trainer, state, batch

    # learning: the convergence gate's configuration and data
    trainer = ProteinTrainer(gate_config(), device="cuda")
    state = trainer.init_state()
    ces = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(LEARN_STEPS):
        batch = rule_batch(step, 16, 48, "cuda")
        state, metrics = trainer.train_step(state, batch)
        ces.append(metrics["denoising_loss"])
    ces = [c.item() for c in ces]
    seconds = time.perf_counter() - t0
    late = sum(ces[-20:]) / 20
    # the kernels against the unfused chain again, at these trained weights
    cfg = trainer.cfg
    batch = rule_batch(LEARN_STEPS, 16, 48, "cuda")
    corrupted = corrupt_batch(batch, cfg.interpolant, gen)
    names, params = zip(*state.model.named_parameters())
    grads = {}
    for fused in (True, False):
        state.model.fused = fused
        metrics = make_loss_fn(cfg)(state.model, batch, 0,
                                    noisy=(corrupted["S_t"], corrupted["t"]))
        metrics.setdefault("proj_loss", torch.zeros((), device=batch["S"].device))
        total, _ = combine_losses(metrics, 0, trainer.curriculum)
        grads[fused] = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(total, params, allow_unused=True), params)]
    state.model.fused = True
    trained_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                      for a, b in zip(grads[True], grads[False]))
    log(f"[train] after {LEARN_STEPS} steps, kernels vs unfused chain: gradients "
        f"max err / max |g| {trained_err:.3g} (rtol {TRAIN_GRAD_RTOL})")
    if not trained_err <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"trained-state gradients differ: {trained_err}")
    log(f"[train] learning check, gate config (16 x 48, rule data): CE step 0 "
        f"{ces[0]:.4f}, step 100 {ces[100]:.4f}, mean of steps "
        f"{LEARN_STEPS - 20}-{LEARN_STEPS - 1} {late:.4f} (must be < {LEARN_CE_MAX}; "
        f"JAX on a TPU: 1.50, 1.16, 1.17); {1e3 * seconds / LEARN_STEPS:.3f} ms per "
        f"step incl. batch upload ({smi})")
    if not late < LEARN_CE_MAX:
        raise AssertionError(f"the CE did not fall: {ces[0]} -> {late}")
    del trainer, state

    # the user's entry point
    t0 = time.perf_counter()
    state = cli.main(["train-protein", "--steps", "3", "--synthetic", "--log-every", "1"])
    torch.cuda.synchronize()
    log(f"[train] cli train-protein --steps 3 --synthetic: {state.step} steps in "
        f"{time.perf_counter() - t0:.2f} s incl. set-up")
    if state.step != 3:
        raise AssertionError(f"train-protein ran {state.step} steps, not 3")
    return launches[1]


def sit_inputs(batch, gen):
    x = torch.randn((batch, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((batch,), generator=gen, device="cuda")
    y = torch.randint(0, 1001, (batch,), generator=gen, device="cuda")
    return x, t, y


@torch.no_grad()
def slice_phase(smi):
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_sit("SiT-XL/2", device="cuda").eval()
    for p in model.parameters():
        p.normal_(0.0, 0.02, generator=gen)
    x, t, y = sit_inputs(MAIN_SHAPE[0], gen)
    for dtype in (torch.float32, torch.bfloat16):
        model.to(dtype)
        model.attn_impl = "auto"
        out = model(x, t, y)[0]
        model.attn_impl = "reference"
        ref = model(x, t, y)[0]
        model.attn_impl = "auto"
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        log(f"[slice] SiT-XL/2 {str(dtype)[6:]} call, kernel vs plain attention: "
            f"max abs err / max |out| = {rel:.3g} (rtol {SIT_RTOL[dtype]}), "
            f"max |out| {ref.abs().max().item():.3g}")
        if not (torch.isfinite(out).all() and rel <= SIT_RTOL[dtype]):
            raise AssertionError(f"SiT-XL/2 {dtype}: rel err {rel}")

    for batch in (GEN["batch_size"], 2 * GEN["batch_size"]):
        xb, tb, yb = sit_inputs(batch, gen)
        ms = cuda_ms(lambda: model(xb, tb, yb), iters=10, warmup=2, queued=False)
        # few calls: ~450 launches each must fit in the device's launch queue
        device_ms = cuda_ms(lambda: model(xb, tb, yb), iters=2, warmup=2)
        log(f"[slice] SiT-XL/2 bf16 model call at batch {batch}: {ms:.3f} ms back to "
            f"back, {device_ms:.3f} ms of device time (calls queued ahead) ({smi})")
    profile(f"SiT-XL/2 bf16 model call at batch {xb.shape[0]}", lambda: model(xb, tb, yb), smi)

    calls = 0

    def model_fn(xx, tt, yy):
        nonlocal calls
        calls += 1
        return model(xx, tt, yy)[0]

    cfg = FIDGenConfig(**GEN)
    torch.cuda.synchronize()
    fa.launches = fm.launches = 0
    t0 = time.perf_counter()
    samples = generate_samples(model_fn, cfg, device="cuda")
    seconds = time.perf_counter() - t0
    launches = fa.launches
    expect_calls = cfg.num_steps * (cfg.num_samples // cfg.batch_size)
    log(f"[slice] generate_samples: {samples.shape[0]} samples, {calls} model "
        f"calls, {launches} flash_attention launches, {seconds:.3f} s incl. "
        f"first batch ({samples.shape[0] / seconds:.2f} imgs/s, "
        f"{1e3 * seconds / calls:.2f} ms per model call; {smi})")
    if not (samples.shape == (cfg.num_samples, 32, 32, 4)
            and bool(torch.isfinite(torch.from_numpy(samples)).all())):
        raise AssertionError(f"generated samples: shape {samples.shape} or non-finite")
    if calls != expect_calls or launches != DEPTH * calls:
        raise AssertionError(f"expected {expect_calls} model calls and "
                             f"{DEPTH} launches per call, got {calls} and {launches}")

    model.attn_impl = "reference"
    ref = generate_samples(model_fn, cfg, device="cuda")
    model.attn_impl = "auto"
    rel = float(abs(samples - ref).max() / abs(ref).max())
    log(f"[slice] generated latents, kernel vs plain attention: max abs err / "
        f"max |ref| = {rel:.3g} (rtol {GEN_RTOL})")
    if not rel <= GEN_RTOL:
        raise AssertionError(f"generated latents rel err {rel}")
    return launches


def kernel_entry(name, replaces, row, launches, source=None):
    return dict(name=name, route="cuda",
                source=f"reed_tpu_torch/csrc/{source or name}.cu",
                replaces=replaces, launches=launches, max_abs_err=row["max_abs_err"],
                ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])


def main():
    smi = device_phase()
    build_phase()
    attn_rows = kernel_phase(smi)
    msg_rows = message_kernel_phase(smi)
    bwd_rows = message_backward_phase(smi)
    attn_launches = slice_phase(smi)
    msg_launches = protein_phase(smi)
    bwd_launches = train_phase(smi)
    kernels = [
        kernel_entry("flash_attention", "reed_tpu/ops/flash_attention.py:24",
                     attn_rows[(MAIN_SHAPE, torch.bfloat16)], attn_launches),
        kernel_entry("fused_message", "reed_tpu/ops/fused_message.py:132",
                     msg_rows[(MSG_MAIN, torch.float32)], msg_launches),
        kernel_entry("fused_message_bwd", "reed_tpu/ops/fused_message.py:152",
                     bwd_rows[(MSG_MAIN, torch.float32)], bwd_launches,
                     source="fused_message"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
