"""Two-stage molecule sampling: a representation first, then the point
cloud conditioned on it (GeoRCG/REED inference), and the replicate loop
that scores it. The port's copy of reed_tpu/eval/two_stage.py (reference:
molecule/models/wrapper.py:18-80, molecule/eval_src/eval_analyze.py,
molecule/semlaflow/evaluate.py:219-332).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from reed_tpu_torch.parallel.mesh import run_rows


def molecule_masks(nodesxsample, max_nodes: int, device=None):
    """(node_mask [B,N,1], edge_mask [B,N,N,1]) f32 on `device` for
    molecules of nodesxsample atoms padded to max_nodes; no self edges."""
    n = torch.as_tensor(np.asarray(nodesxsample), device=device)
    node_mask = (torch.arange(max_nodes, device=device)[None] < n[:, None]).float()[..., None]
    diag = torch.eye(max_nodes, device=device)[None, :, :, None]
    edge_mask = node_mask[:, :, None, :] * node_mask[:, None, :, :] * (1 - diag)
    return node_mask, edge_mask


class TwoStageSampler:
    """rep_sampler.sample(np_rng, nodesxsample) -> reps [B, D];
    mol_sampler(node_mask, edge_mask, rep) -> (x, h_cat, h_int); fixed_rep,
    where given, replaces the rep sampler; with neither, rep is None (an
    unconditional model). Under `dp` (a parallel.mesh.DataParallel) the
    masks and the rep stage are made whole on every rank, as reed_tpu runs
    its rep sampler off the mesh; mol_sampler then runs this batch index's
    rows of them inside draws.global_rows, and its output is gathered back
    into the global batch on every rank (parallel.mesh.run_rows)."""

    def __init__(self, rep_sampler, mol_sampler: Callable, fixed_rep=None, dp=None):
        self.rep_sampler = rep_sampler
        self.mol_sampler = mol_sampler
        self.fixed_rep = fixed_rep
        self.dp = dp

    def sample(self, np_rng: np.random.Generator, nodesxsample, max_nodes: int,
               device=None):
        """-> (x, h_cat, h_int, node_mask), tensors on `device`."""
        node_mask, edge_mask = molecule_masks(nodesxsample, max_nodes, device)
        rep = self.fixed_rep
        if rep is None and self.rep_sampler is not None:
            t0 = time.perf_counter()
            rep = self.rep_sampler.sample(np_rng, np.asarray(nodesxsample))
            print(f"rep sampling of {len(nodesxsample)} took {time.perf_counter() - t0:.2f}s")
        if rep is not None:
            rep = torch.as_tensor(rep, dtype=torch.float32, device=device)
        x, h_cat, h_int = run_rows(self.dp, node_mask.shape[0], (node_mask, edge_mask, rep),
                                   lambda rows: self.mol_sampler(*rows))
        return x, h_cat, h_int, node_mask


def evaluate_replicates(sample_fn: Callable[[int], List], metrics,
                        n_replicates: int = 3) -> Dict:
    """Run `sample_fn(replicate) -> [(positions, atom_types), ...]`
    n_replicates times, score each with `metrics.evaluate`, and aggregate
    the mean and std of every metric."""
    results: Dict[str, List[float]] = {}
    for r in range(n_replicates):
        for k, v in metrics.evaluate(sample_fn(r)).items():
            results.setdefault(k, []).append(float(v))
    return {"mean": {k: float(np.mean(v)) for k, v in results.items()},
            "std": {k: float(np.std(v)) for k, v in results.items()},
            "all": results}


def molecules_from_samples(x, h_cat, node_mask) -> List:
    """Dense sampler outputs -> [(positions [n,3], atom_types [n]), ...]."""
    x = torch.as_tensor(x).cpu().numpy()
    types = torch.argmax(torch.as_tensor(h_cat), dim=-1).cpu().numpy()
    mask = torch.as_tensor(node_mask)[..., 0].cpu().numpy().astype(bool)
    return [(x[i][mask[i]], types[i][mask[i]]) for i in range(x.shape[0])]
