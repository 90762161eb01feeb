"""Chip smoke test of the PyTorch/CUDA port (reed_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result):
  1. device: a CUDA device is required; prints its name and power limit.
  2. build: every kernel under reed_tpu_torch/csrc/, one nvcc each, together.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it (and a few more), with stated
     tolerances; kernel, plain and library (yardstick only) times and the
     least time the card could take for the same work (bound_ms).
  4. slice: SiT-XL/2 at full width with seeded N(0, 0.02) weights (nonzero
     adaLN and final layer, so attention reaches the output): one model call
     through the kernel against the same call with plain attention, in f32
     and bf16; then the main path, `generate_samples` (SDE with CFG inside
     a guidance window), with every kernel's launch count set to 0 just
     before it and read just after, and its samples against a run with
     plain attention.
  5. output: a {"kernels": [...]} line, the nvidia-smi line, and last the
     {"ok": true, "device": {...}} line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from reed_tpu_torch import _build
from reed_tpu_torch.eval.fid import FIDGenConfig, generate_samples
from reed_tpu_torch.models.sit import create_sit
from reed_tpu_torch.ops import flash_attention as fa

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain attention, max abs error on N(0, 1) inputs. f32: both
# accumulate in f32, only the summation order differs. bf16: the plain
# version rounds logits and probabilities to bf16 (the kernel keeps f32),
# which costs up to ~2 bf16 ulps of outputs up to |4|.
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
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


def build_phase():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def cuda_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, dtype):
    b, s, h, d = shape
    nbytes = 4 * b * s * h * d * torch.finfo(dtype).bits // 8  # q, k, v, o
    flops = 4 * b * h * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                       for _ in range(3))
            out = fa.flash_attention_kernel(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - fa.sdpa_reference(q, k, v).float()).abs().max().item()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bound, bound_by = attention_bound(shape, dtype)
            row = dict(max_abs_err=err, atol=ATTN_ATOL[dtype],
                       ms=cuda_ms(lambda: fa.flash_attention_kernel(q, k, v)),
                       plain_ms=cuda_ms(lambda: fa.sdpa_reference(q, k, v)),
                       bound_ms=bound, bound_by=bound_by,
                       library_ms=cuda_ms(
                           lambda: F.scaled_dot_product_attention(qt, kt, vt)))
            rows[(shape, dtype)] = row
            log(f"[kernel] flash_attention {shape} {str(dtype)[6:]}: "
                + json.dumps(row))
            if not err <= ATTN_ATOL[dtype]:
                raise AssertionError(f"flash_attention {shape} {dtype}: max abs "
                                     f"err {err} > {ATTN_ATOL[dtype]}")
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
        ms = cuda_ms(lambda: model(xb, tb, yb), iters=10, warmup=2)
        log(f"[slice] SiT-XL/2 bf16 model call at batch {batch}: {ms:.3f} ms ({smi})")

    calls = 0

    def model_fn(xx, tt, yy):
        nonlocal calls
        calls += 1
        return model(xx, tt, yy)[0]

    cfg = FIDGenConfig(**GEN)
    torch.cuda.synchronize()
    fa.launches = 0
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


def main():
    smi = device_phase()
    build_phase()
    rows = kernel_phase()
    launches = slice_phase(smi)
    main_row = rows[(MAIN_SHAPE, torch.bfloat16)]
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="reed_tpu_torch/csrc/flash_attention.cu",
        replaces="reed_tpu/ops/flash_attention.py:24",
        launches=launches, max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
