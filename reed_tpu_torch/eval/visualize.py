"""Image grids for preview sampling, counterpart of the image half of
reed_tpu/eval/visualize.py. The PNG is written with the standard library
(zlib and struct), so no imaging package is needed."""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional

import numpy as np


def image_grid(images: np.ndarray, nrow: Optional[int] = None) -> np.ndarray:
    """[B, H, W, C] -> one grid image, `nrow` images a row (default
    round(sqrt(B)))."""
    b, h, w, c = images.shape
    nrow = nrow or round(math.sqrt(b))
    ncol = math.ceil(b / nrow)
    grid = np.zeros((ncol * h, nrow * w, c), images.dtype)
    for i in range(b):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return grid


def write_png(path: str, image: np.ndarray):
    """uint8 RGB [H, W, 3] as an 8-bit PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, _ = image.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # every scanline starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def save_image_grid(path: str, images: np.ndarray, nrow: Optional[int] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, image_grid(images, nrow))
