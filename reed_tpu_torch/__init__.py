"""reed_tpu_torch: the PyTorch/CUDA port of reed_tpu for NVIDIA Hopper.

Mirrors reed_tpu's module layout and names. Plain tensor code is PyTorch;
the Pallas kernels of reed_tpu become hand-written CUDA kernels under
`csrc/`, built with nvcc at first use (`_build.py`). Entry points run on
`cuda` unless the caller asks for the CPU; on the CPU every kernel wrapper
runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`cuda` unless another device is asked for; raises when the device
    asked for (or the default) is CUDA and no CUDA device is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for `device`'s queued work where it is a CUDA device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
