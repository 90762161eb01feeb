"""Design variants of the fused message kernels (K2a, K2b), timed on one GPU.

    python -m reed_tpu_torch.tools.message_variants

Each variant is csrc/fused_message.cu with one design choice undone by a
text substitution of its constant: tile rows (64 as built; 96, 128), 16
warps a block on 128-row tiles (8 as built), the ring depth (two stages as
built; three), and K2b's weight gradients (as
built: the tile kernel writes the rounded operands and a second kernel runs
them as long TN products over fixed row ranges; the variant adds each
tile's TN products into per-block partials inside the tile kernel). All are
built together with the port's nvcc flags into reed_tpu_torch/_build/
variants/, held against the plain versions (f32: K2a atol 1e-4, K2b 1e-4
of each gradient's max, as in chip_smoke.py) and timed in turns (device ms,
calls queued ahead) at ProteinMPNN's decoder and encoder cases in f32.
It also measures the rate mma.sync reaches on the card, for TF32
(m16n8k8) and bf16 (m16n8k16), with eight independent accumulators a warp
and two blocks of 8 warps an SM: the ceiling of the kernels' products.
Prints the rates, each variant's ptxas lines and blocks per SM, then one
JSON line per case and kernel. Needs a CUDA device; exits non-zero on a
build failure or a mismatch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from reed_tpu_torch import _build
from reed_tpu_torch.ops import fused_message as fm
from reed_tpu_torch.tools.cuda_timing import cuda_ms, timed_in_turns

ROWS = "constexpr int kFwdRows = 64;", "constexpr int kBwdRows = 64;"
STAGES = "constexpr int kFwdStages = 2;", "constexpr int kBwdStages = 2;"
VARIANTS = {
    "as built": [],
    "96-row tiles": [(r, r.replace("64", "96")) for r in ROWS],
    "128-row tiles": [(r, r.replace("64", "128")) for r in ROWS],
    "16 warps a block, 128-row tiles": [
        ("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")]
    + [(r, r.replace("64", "128")) for r in ROWS],
    "three ring stages": [(s, s.replace("2;", "3;")) for s in STAGES],
    "K2b weight gradients in the tile kernel (design a)": [
        ("constexpr bool kWgradInTile = false;", "constexpr bool kWgradInTile = true;")],
}
# (B, L, K, D, Ce), mask mode, outputs: DecLayer and EncLayer chain 1
CASES = [((8, 256, 30, 128, 256), "pre", "both"), ((8, 256, 30, 128, 128), "post", "sum")]
ATOL = 1e-4
RTOL = 1e-4

MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define MMA(shape, type)                                                                   \
  asm volatile("mma.sync.aligned." shape ".row.col.f32." type "." type ".f32 "             \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"       \
               : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <bool kBf16>
__global__ void rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kBf16) MMA("m16n8k16", "bf16"); else MMA("m16n8k8", "tf32");
    }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int bf16, float* out, int blocks, int iters) {
  if (bf16) rate<true><<<blocks, 256>>>(out, iters); else rate<false><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rates():
    """{"tf32" | "bf16": TFLOP/s that mma.sync reaches on the current card}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(MMA_RATE_SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 4000
    out = torch.empty(blocks * 256, device="cuda")
    rates = {}
    for bf16, name, flops in ((0, "tf32", 2 * 16 * 8 * 8), (1, "bf16", 2 * 16 * 8 * 16)):
        ms = cuda_ms(lambda: fn(bf16, out.data_ptr(), blocks, iters), iters=5, warmup=2)
        rates[name] = blocks * 8 * iters * 8 * flops / (ms * 1e-3) / 1e12
    return rates


def variant_sources(source):
    """{name: the kernel source with that variant's edits}; raises if an
    edit does not match the source exactly once."""
    out = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants():
    """{name: (library, ptxas lines of the f32 kernels)}."""
    sources = variant_sources((_build.CSRC / "fused_message.cu").read_text())
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = out_dir / f"fm{i}.cu"
        src.write_text(text)
        lib = out_dir / f"libfm{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        report, entry = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line and entry and "Tf32x3" in entry:
                kernel = next((k for k in ("fwd", "bwd_partials", "bwd", "wgrad")
                               if f"fused_message_{k}_kernel" in entry), None)
                if kernel:
                    report.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        built[name] = (fm.bind(ctypes.CDLL(str(lib))), report)
    return built


def inputs(case, gen):
    (b, l, k, d, ce), mode, outputs = case

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    kw = dict(pre_self=randn(b, l, d, std=0.5), e_feat=randn(b, l, k, ce),
              nbr_src=randn(b, l, d, std=0.5),
              e_idx=torch.randint(0, l, (b, l, k), generator=gen, device="cuda",
                                  dtype=torch.int32),
              w_e=randn(ce, d, std=ce ** -0.5), w2=randn(d, d, std=d ** -0.5),
              b2=randn(d, std=0.1), w3=randn(d, d, std=d ** -0.5), b3=randn(d, std=0.1),
              mask=(torch.rand((b, l, k), generator=gen, device="cuda") < 0.8).float(),
              mask_mode=mode)
    flags = dict(want_sum=outputs != "msg", want_msg=outputs != "sum")
    cots = dict(gdh=randn(b, l, d) if flags["want_sum"] else None,
                gmsg=randn(b, l, k, d) if flags["want_msg"] else None)
    return kw, flags, cots


def main():
    if not torch.cuda.is_available():
        sys.exit("message_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[variants] {smi}", flush=True)
    print("[variants] mma.sync rate, TFLOP/s: " + json.dumps(mma_rates()), flush=True)
    built = build_variants()
    for name, (lib, report) in built.items():
        occupancy = []
        for which, kernel in enumerate(fm.KERNEL_NAMES):
            try:
                smem, blocks, rows = fm.kernel_info(torch.float32, which, lib=lib)
            except RuntimeError:  # no weight-gradient kernel in design a
                continue
            occupancy.append(f"{kernel} {rows} rows, {smem} bytes, {blocks} blocks/SM")
        print(f"[variants] {name}: " + "; ".join(report + occupancy), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for case in CASES:
        kw, flags, cots = inputs(case, gen)
        ref = [r for r in fm.fused_message_reference(**kw, **flags) if r is not None]
        ref_bwd = fm.fused_message_backward_reference(**kw, **cots)
        fwd, bwd, errs = {}, {}, {}
        for name, (lib, _) in built.items():
            out = [o for o in fm.launch(**kw, **flags, lib=lib) if o is not None]
            grads = fm.launch_backward(**kw, **cots, lib=lib)
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(out, ref))
            rel = max(((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
                      for g, r in zip(grads, ref_bwd))
            errs[name] = {"fwd_max_abs_err": err, "bwd_max_rel_err": rel}
            if not (err <= ATOL and rel <= RTOL):
                failed.append((case, name, errs[name]))
            fwd[name] = lambda lib=lib: fm.launch(**kw, **flags, lib=lib)
            bwd[name] = lambda lib=lib: fm.launch_backward(**kw, **cots, lib=lib)
        for kernel, fns in (("K2a", fwd), ("K2b", bwd)):
            print(json.dumps({"case": case, "kernel": kernel,
                              "device_ms": timed_in_turns(fns, iters=20), "card": smi}),
                  flush=True)
        print(json.dumps({"case": case, "errors": errs}), flush=True)
    if failed:
        sys.exit(f"message_variants: variants differ from the plain versions: {failed}")


if __name__ == "__main__":
    main()
