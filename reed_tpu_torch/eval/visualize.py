"""Image grids for preview sampling and molecule files, counterpart of the
image and molecule halves of reed_tpu/eval/visualize.py. The image grid's
PNG is written with the standard library (zlib and struct), so no imaging
package is needed; the .xyz and V2000 .sdf writers need no RDKit and write
the same bytes as reed_tpu's. The 3D molecule renders (plot_molecule_3d)
need matplotlib, imported where they are drawn (`have_matplotlib`)."""

from __future__ import annotations

import importlib.util
import math
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

QM9_ATOM_DECODER = ["H", "C", "N", "O", "F"]

# atom display colors/radii by element (reference:
# molecule/configs/datasets_config.py colors_dic/radius_dic)
ATOM_COLORS = {"H": "#FFFFFF99", "C": "C7", "N": "C0", "O": "C3", "F": "C1",
               "S": "C5", "Cl": "C8", "Br": "C9", "P": "C4", "I": "C6",
               "B": "C2", "Si": "C2", "Al": "C2", "As": "C2", "Hg": "C2",
               "Bi": "C2"}
ATOM_RADII = {"H": 0.46}


def have_matplotlib() -> bool:
    """Whether matplotlib, which plot_molecule_3d draws with, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def plot_molecule_3d(path: str, positions: np.ndarray, atom_types: Sequence[int],
                     atom_decoder: Sequence[str] = QM9_ATOM_DECODER, bg: str = "black",
                     camera_elev: float = 10.0, camera_azim: float = -60.0,
                     alpha: float = 1.0, dpi: int = 120, title: str = ""):
    """Render one molecule as a 3D scatter + inferred-bond PNG (reference:
    molecule/qm9/visualizer.py plot_data3d/plot_molecule: bonds drawn where
    get_bond_order > 0, thicker for aromatic orders, matplotlib 3D axes with
    hidden panes). Returns the saved path; raises ImportError without
    matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from reed_tpu_torch.eval.molecule_metrics import get_bond_order

    positions = np.asarray(positions, np.float64)
    atom_types = np.asarray(atom_types, np.int64)
    symbols = [atom_decoder[int(t)] for t in atom_types]
    black, white = (0, 0, 0), (1, 1, 1)
    hex_bg_color = "#FFFFFF" if bg == "black" else "#666666"

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.set_facecolor(black if bg == "black" else white)
    ax.view_init(elev=camera_elev, azim=camera_azim)
    ax.xaxis.pane.set_alpha(0)
    ax.yaxis.pane.set_alpha(0)
    ax.zaxis.pane.set_alpha(0)
    ax.set_axis_off()

    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    radii = np.array([ATOM_RADII.get(s, 0.77) for s in symbols])
    colors = [ATOM_COLORS.get(s, "C2") for s in symbols]
    ax.scatter(x, y, z, s=1500 * radii ** 2, alpha=0.9 * alpha, c=colors)

    n = len(symbols)
    for i in range(n):
        for j in range(i + 1, n):
            dist = float(np.linalg.norm(positions[i] - positions[j]))
            order = get_bond_order(symbols[i], symbols[j], dist, check_exists=True)
            if order > 0:
                ax.plot([x[i], x[j]], [y[i], y[j]], [z[i], z[j]],
                        linewidth=4 * (1.5 if order >= 4 else 1.0), c=hex_bg_color,
                        alpha=alpha)

    # equal aspect (matplotlib 3D has no set_aspect('equal'))
    span = positions.max(0) - positions.min(0)
    center = (positions.max(0) + positions.min(0)) / 2
    r = max(float(span.max()) / 2, 1e-3)
    ax.set_xlim(center[0] - r, center[0] + r)
    ax.set_ylim(center[1] - r, center[1] + r)
    ax.set_zlim(center[2] - r, center[2] + r)
    if title:
        ax.set_title(title, color=hex_bg_color)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=dpi, facecolor=black if bg == "black" else white,
                bbox_inches="tight")
    plt.close(fig)
    return path


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


def save_xyz_file(path: str, positions: np.ndarray, atom_types: Sequence[int],
                  atom_decoder: Sequence[str] = QM9_ATOM_DECODER,
                  comment: str = ""):
    """Write one molecule as .xyz (reference: qm9/visualizer.py)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{len(atom_types)}\n{comment}\n")
        for pos, t in zip(np.asarray(positions), atom_types):
            f.write(f"{atom_decoder[int(t)]} "
                    f"{pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f}\n")


def save_molecules_xyz(out_dir: str, molecules: List, prefix: str = "mol",
                       atom_decoder: Sequence[str] = QM9_ATOM_DECODER):
    """molecules: [(positions [N,3], atom_types [N]), ...]"""
    os.makedirs(out_dir, exist_ok=True)
    for i, (pos, types) in enumerate(molecules):
        save_xyz_file(os.path.join(out_dir, f"{prefix}_{i:04d}.xyz"),
                      pos, types, atom_decoder)


def save_sdf_file(path: str, positions: np.ndarray, atom_types: Sequence[int],
                  bond_orders: np.ndarray,
                  atom_decoder: Sequence[str] = QM9_ATOM_DECODER,
                  name: str = "mol"):
    """Write one molecule as a V2000 molfile/.sdf with explicit bonds
    (reference counterpart: molecule/semlaflow/predict.py writes sampled
    molecules to SDF via RDKit; this writer needs no RDKit). bond_orders
    [N,N] symmetric int (0 = none, 1/2/3 = bond order)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    positions = np.asarray(positions)
    bond_orders = np.asarray(bond_orders)
    bonds = [(i, j, int(bond_orders[i, j]))
             for i in range(len(atom_types))
             for j in range(i + 1, len(atom_types))
             if bond_orders[i, j] > 0]
    with open(path, "w") as f:
        f.write(f"{name}\n  reed_tpu\n\n")
        f.write(f"{len(atom_types):>3d}{len(bonds):>3d}  0  0  0  0  0  0  "
                f"0  0999 V2000\n")
        for pos, t in zip(positions, atom_types):
            f.write(f"{pos[0]:>10.4f}{pos[1]:>10.4f}{pos[2]:>10.4f} "
                    f"{atom_decoder[int(t)]:<3s} 0  0  0  0  0  0  0  0  "
                    f"0  0  0  0\n")
        for i, j, order in bonds:
            # V2000 bond types: 1/2/3 = single/double/triple, 4 = aromatic
            f.write(f"{i + 1:>3d}{j + 1:>3d}{min(order, 4):>3d}  0  0  0  0\n")
        f.write("M  END\n$$$$\n")
    return path
