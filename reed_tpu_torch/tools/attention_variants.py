"""Design variants of the flash-attention kernel (K1), timed on one GPU.

    python -m reed_tpu_torch.tools.attention_variants

Each variant is csrc/flash_attention.cu with one design choice undone by a
text substitution. bf16: one m16 tile a warp (64 queries a block, or 128
with 8 warps), a third K/V ring stage, exp2f in place of ex2.approx.ftz.
f32 (3xTF32): the CUDA-core kernel it replaced, Q fragments re-read from
shared memory each k-step instead of held in registers, two m16 tiles a
warp, 32-key tiles, 8 warps a block, a third ring stage. All are built
together with the port's nvcc flags into reed_tpu_torch/_build/variants/,
held against the plain versions at SiT's shapes (bf16 against
flash_attention_reference at atol 8e-3, f32 against sdpa_reference at 1e-4,
as in chip_smoke.py) and timed in turns with SDPA (and, in f32, the plain
version) as device ms, calls queued ahead. Prints each variant's ptxas line
and blocks per SM of the D = 72 kernel, then one JSON line per shape and
dtype, then the device ms of a full-width SiT-XL/2 f32 model call at batch
16 (seeded N(0, 0.02) weights) with K1 as built, with the CUDA-core f32
kernel and with plain attention, in turns. Needs a CUDA device; exits
non-zero on a build failure or a mismatch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from reed_tpu_torch import _build
from reed_tpu_torch.models.sit import create_sit
from reed_tpu_torch.ops import flash_attention as fa
from reed_tpu_torch.tools.cuda_timing import timed_in_turns

ONE_TILE = ("kRowTiles = kD <= 80 ? 2 : 1;", "kRowTiles = 1;")
Q_SMEM = ("kF32QInRegs = true;", "kF32QInRegs = false;")
KEYS_32 = ("kF32BlockN = 64;", "kF32BlockN = 32;")
CUDA_CORES = "f32: CUDA-core kernel (no tensor cores)"
BF16_VARIANTS = {
    "one m16 tile a warp, 4 warps (64 queries a block)": [ONE_TILE],
    "one m16 tile a warp, 8 warps (128 queries a block)": [
        ONE_TILE, ("kMmaWarps = 4;", "kMmaWarps = 8;")],
    "three K/V ring stages": [("kStages = 2;", "kStages = 3;")],
    "exp2f for ex2.approx.ftz": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
}
F32_VARIANTS = {
    CUDA_CORES: [
        ("kF32TensorCores = true;", "kF32TensorCores = false;")],
    "f32: Q fragments re-read from shared memory": [Q_SMEM],
    "f32: Q from shared memory, 32-key tiles, 3 blocks an SM": [
        Q_SMEM, KEYS_32, ("kF32MinBlocks = 2;", "kF32MinBlocks = 3;")],
    "f32: two m16 tiles a warp, Q from shared memory, 32-key tiles": [
        Q_SMEM, KEYS_32, ("kF32RowTiles = 1;", "kF32RowTiles = 2;")],
    "f32: 32-key tiles": [KEYS_32],
    "f32: 8 warps a block (128 queries)": [
        ("kF32Warps = 4;", "kF32Warps = 8;"), ("kF32MinBlocks = 2;", "kF32MinBlocks = 1;")],
    "f32: three K/V ring stages": [("kF32Stages = 2;", "kF32Stages = 3;")],
}
VARIANTS = {"as built": [], **BF16_VARIANTS, **F32_VARIANTS}
SHAPES = [(16, 256, 16, 72), (8, 256, 16, 72), (4, 1024, 16, 72), (8, 64, 6, 64),
          (2, 200, 4, 72)]
ATOL = {torch.bfloat16: 8e-3, torch.float32: 1e-4}
PLAIN = {torch.bfloat16: fa.flash_attention_reference, torch.float32: fa.sdpa_reference}


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


def dtypes_of(name):
    """The dtypes a variant changes (both for the kernel as built)."""
    if name in BF16_VARIANTS:
        return (torch.bfloat16,)
    if name in F32_VARIANTS:
        return (torch.float32,)
    return (torch.bfloat16, torch.float32)


def ptxas_line(log, symbol):
    """Registers, stack and spills ptxas reported for the first entry
    function whose mangled name contains `symbol`."""
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry function" in line and symbol in line)
    return "; ".join(line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                     if "registers" in line or "spill" in line)


def build_variants():
    """{name: (library, {dtype: ptxas line of its D = 72 kernel})}."""
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
        f32_symbol = "17attention_fwd_f32E" if name == CUDA_CORES else "f32_mmaILi72E"
        reports = {torch.bfloat16: ptxas_line(log, "bf16_mmaILi72E"),
                   torch.float32: ptxas_line(log, f32_symbol)}
        built[name] = (fa.bind(ctypes.CDLL(str(lib))), reports)
    return built


def main():
    if not torch.cuda.is_available():
        sys.exit("attention_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[variants] {smi}", flush=True)
    built = build_variants()
    for name, (lib, reports) in built.items():
        for dtype in dtypes_of(name):
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            lib.reed_flash_attention_info(int(dtype == torch.bfloat16), 72,
                                          ctypes.byref(smem), ctypes.byref(blocks))
            print(f"[variants] {name}: {str(dtype)[6:]} D 72: {reports[dtype]}; "
                  f"{smem.value} bytes of shared memory, {blocks.value} blocks per SM",
                  flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        names = [n for n in built if dtype in dtypes_of(n)]
        for shape in SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                       for _ in range(3))
            ref = PLAIN[dtype](q, k, v).float()
            errs, fns = {}, {}
            for name in names:
                lib = built[name][0]
                out = fa.launch(q, k, v, lib=lib)
                torch.cuda.synchronize()
                errs[name] = (out.float() - ref).abs().max().item()
                fns[name] = lambda lib=lib: fa.launch(q, k, v, lib=lib)
                if not errs[name] <= ATOL[dtype]:
                    failed.append((shape, str(dtype), name, errs[name]))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            fns["SDPA"] = lambda: F.scaled_dot_product_attention(qt, kt, vt)
            if dtype == torch.float32:
                fns["sdpa_reference"] = lambda: fa.sdpa_reference(q, k, v)
            print(json.dumps({"shape": shape, "dtype": str(dtype)[6:],
                              "device_ms": timed_in_turns(fns), "max_abs_err": errs,
                              "card": smi}), flush=True)
    sit_call(built, smi)
    if failed:
        sys.exit(f"attention_variants: variants differ from the plain version: {failed}")


@torch.no_grad()
def sit_call(built, smi, batch=16):
    """Device ms of one SiT-XL/2 f32 model call (28 K1 launches) with K1 as
    built, with the CUDA-core f32 kernel, and with plain attention."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_sit("SiT-XL/2", device="cuda").eval()
    for p in model.parameters():
        p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((batch, 32, 32, 4), generator=gen, device="cuda")
    t = torch.rand((batch,), generator=gen, device="cuda")
    y = torch.randint(0, 1001, (batch,), generator=gen, device="cuda")
    kernel = fa._kernel

    def call(lib=None):
        # the model's wrapper launches whichever library _kernel returns
        fa._kernel = (lambda: lib) if lib is not None else kernel
        model.attn_impl = "auto" if lib is not None else "reference"
        try:
            return model(x, t, y)[0]
        finally:
            fa._kernel, model.attn_impl = kernel, "auto"

    # few calls a turn: ~590 launches each must fit in the device's queue
    times = timed_in_turns({
        "as built": lambda: call(built["as built"][0]),
        CUDA_CORES: lambda: call(built[CUDA_CORES][0]),
        "plain attention (sdpa_reference)": call}, iters=2)
    print(json.dumps({"SiT-XL/2 f32 model call, batch": batch, "device_ms": times,
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
