"""Synthetic data with a learnable rule, for convergence runs. The port's
copy of the protein part of reed_tpu/data/synthetic.py (numpy)."""

from __future__ import annotations

from typing import Dict

import numpy as np

# O-atom offset magnitude encodes the residue type: d(s) = 3.0 + 0.4 s,
# spanning 3.0..10.6 A, inside ops/graph.rbf's [2, 22] A window with one
# code point every 0.4 A (well above the 1.25 A RBF width).
O_CODE_BASE = 3.0
O_CODE_STEP = 0.4


def protein_rule_batch(rng: np.random.Generator, batch_size: int,
                       length: int, single_dim: int = 8, pair_dim: int = 4,
                       structure_dim: int = 8) -> Dict[str, np.ndarray]:
    """Backbones whose O-atom offset length encodes the residue identity, in
    the schema of featurize() (reference protein/fmif/model_utils.py:17-165);
    the repr_* entries are zeros (alignment off for convergence runs). The
    same draws from `rng` as reed_tpu's, so the same batch for one seed."""
    s = rng.integers(0, 20, size=(batch_size, length))
    steps = rng.standard_normal((batch_size, length, 3)).astype(np.float32) * 1.5
    ca = np.cumsum(steps, axis=1)
    ca[..., 0] += 3.8 * np.arange(length, dtype=np.float32)
    x = np.zeros((batch_size, length, 4, 3), np.float32)
    x[:, :, 0] = ca + np.array([-1.46, 0.0, 0.0], np.float32)   # N
    x[:, :, 1] = ca                                              # Ca
    x[:, :, 2] = ca + np.array([1.52, 0.0, 0.0], np.float32)    # C
    d = (O_CODE_BASE + O_CODE_STEP * s).astype(np.float32)
    x[:, :, 3] = ca + d[..., None] * np.array([0.0, 0.0, 1.0], np.float32)
    return {
        "X": x,
        "S": s.astype(np.int32),
        "mask": np.ones((batch_size, length), np.float32),
        "chain_M": np.ones((batch_size, length), np.float32),
        "residue_idx": np.broadcast_to(
            np.arange(length, dtype=np.int32)[None], (batch_size, length)).copy(),
        "chain_encoding_all": np.zeros((batch_size, length), np.int32),
        "repr_single": np.zeros((batch_size, length, single_dim), np.float32),
        "repr_pair": np.zeros((batch_size, length, length, pair_dim), np.float32),
        "repr_structure": np.zeros((batch_size, length, structure_dim), np.float32),
    }
