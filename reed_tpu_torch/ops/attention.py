"""Attention entry point: the flash kernel on CUDA, the plain version on CPU.

`multi_head_attention` is the one entry point SiT uses. The TPU rule of
reed_tpu (XLA below S = 1024) was measured on a TPU and does not carry over:
here every CUDA call goes through the hand-written kernel.
"""

from __future__ import annotations

from reed_tpu_torch.ops.flash_attention import flash_attention, sdpa_reference

# The plain version on [B, S, H, D], counterpart of reed_tpu's sdpa_xla.
sdpa = sdpa_reference


def multi_head_attention(q, k, v, mask=None, impl: str = "auto"):
    """q, k, v: [B, S, H, D] -> [B, S, H, D].

    impl: 'auto' runs the kernel for CUDA tensors and `sdpa` for CPU ones;
    'reference' forces `sdpa` (for comparisons with the kernel)."""
    if impl == "reference":
        return sdpa(q, k, v, mask=mask)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'reference', got {impl!r}")
    return flash_attention(q, k, v, mask=mask)
