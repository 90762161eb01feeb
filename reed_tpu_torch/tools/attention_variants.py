"""Design variants of the bf16 flash-attention kernel (K1), timed on one GPU.

    python -m reed_tpu_torch.tools.attention_variants

Each variant is csrc/flash_attention.cu with one design choice undone by a
text substitution: one m16 tile a warp (64 queries a block, or 128 with 8
warps), a third K/V ring stage, exp2f in place of ex2.approx.ftz. All are
built together with the port's nvcc flags into reed_tpu_torch/_build/
variants/, held against flash_attention_reference at SiT's shapes (bf16,
atol 8e-3 as in chip_smoke.py) and timed in turns with SDPA (device ms,
calls queued ahead). Prints the D = 72 kernel's ptxas line and blocks per
SM for each variant, then one JSON line per shape. Needs a CUDA device;
exits non-zero on a build failure or a mismatch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from reed_tpu_torch import _build
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.tools.cuda_timing import timed_in_turns

ONE_TILE = ("kRowTiles = kD <= 80 ? 2 : 1;", "kRowTiles = 1;")
VARIANTS = {
    "as built": [],
    "one m16 tile a warp, 4 warps (64 queries a block)": [ONE_TILE],
    "one m16 tile a warp, 8 warps (128 queries a block)": [
        ONE_TILE, ("kMmaWarps = 4;", "kMmaWarps = 8;")],
    "three K/V ring stages": [("kStages = 2;", "kStages = 3;")],
    "exp2f for ex2.approx.ftz": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
}
SHAPES = [(16, 256, 16, 72), (8, 256, 16, 72), (4, 1024, 16, 72), (8, 64, 6, 64)]
ATOL = 8e-3


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
    """{name: (library, ptxas line of the D = 72 kernel)}."""
    sources = variant_sources((_build.CSRC / "flash_attention.cu").read_text())
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = out_dir / f"v{i}.cu"
        src.write_text(text)
        lib = out_dir / f"libv{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line and "mmaILi72E" in line)
        report = "; ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                           if "registers" in line or "spill" in line)
        built[name] = (fa.bind(ctypes.CDLL(str(lib))), report)
    return built


def main():
    if not torch.cuda.is_available():
        sys.exit("attention_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[variants] {smi}", flush=True)
    built = build_variants()
    for name, (lib, report) in built.items():
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        lib.reed_flash_attention_info(1, 72, ctypes.byref(smem), ctypes.byref(blocks))
        print(f"[variants] {name}: D 72: {report}; {smem.value} bytes of shared "
              f"memory, {blocks.value} blocks per SM", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        ref = fa.flash_attention_reference(q, k, v).float()
        errs, fns = {}, {}
        for name, (lib, _) in built.items():
            out = fa.launch(q, k, v, lib=lib)
            torch.cuda.synchronize()
            errs[name] = (out.float() - ref).abs().max().item()
            fns[name] = lambda lib=lib: fa.launch(q, k, v, lib=lib)
            if not errs[name] <= ATOL:
                failed.append((shape, name, errs[name]))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns["SDPA"] = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        print(json.dumps({"shape": shape, "device_ms": timed_in_turns(fns),
                          "max_abs_err": errs, "card": smi}), flush=True)
    if failed:
        sys.exit(f"attention_variants: variants differ from the plain version: {failed}")


if __name__ == "__main__":
    main()
