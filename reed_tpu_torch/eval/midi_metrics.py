"""MiDi sampling metrics: distribution distances between generated molecules
and dataset statistics; the port's copy of reed_tpu/eval/midi_metrics.py
(host-side numpy).

The numpy counterpart of
molecule/eval_src/midi_metrics/midi/metrics/molecular_metrics.py:241-452
(SamplingMetrics' distance block): number-of-nodes W1, atom-type and
bond-type total variation, per-atom-type charge W1, valency W1, bond-length
W1 (0.01 A bins per bond type), and bond-angle W1 (0.1 deg bins per atom
type), each weighted by the dataset's atom/bond-type probabilities.

Instead of the reference's pickled dataset_infos, `dataset_statistics`
computes every target histogram directly from a reference molecule set, so
the two sides of each distance go through identical featurization.
Molecules are the port's `data.molecule.GeometricMol` records.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

AROMATIC_BOND = 4            # counted as valency 1.5 (molecular_metrics.py:313)
CHARGE_OFFSET = 2            # charges -2..+4 -> bins 0..6
N_CHARGE_BINS = 7
ANGLE_BINS = 1801            # 0.1-degree bins over [0, 180]


def _normalize(h: np.ndarray, axis=-1) -> np.ndarray:
    s = h.sum(axis=axis, keepdims=True)
    return h / np.where(s == 0, 1.0, s)


def histogram_w1(pred: np.ndarray, target: np.ndarray,
                 step_size: float = 1.0) -> float:
    """W1 between two regularly-binned histograms (cumsum-difference form,
    metrics_utils.py:194-204)."""
    n = max(len(pred), len(target))
    p = np.zeros(n)
    t = np.zeros(n)
    p[:len(pred)] = _normalize(np.asarray(pred, np.float64))
    t[:len(target)] = _normalize(np.asarray(target, np.float64))
    return float(np.abs(np.cumsum(p) - np.cumsum(t)).sum() * step_size)


def total_variation1d(pred: np.ndarray, target: np.ndarray) -> float:
    p = _normalize(np.asarray(pred, np.float64))
    t = _normalize(np.asarray(target, np.float64))
    return float(np.abs(p - t).sum())


def _dense_adj(mol) -> np.ndarray:
    n = mol.seq_length
    adj = np.zeros((n, n), np.int64)
    for (i, j), t in zip(mol.bond_indices, mol.bond_types):
        adj[int(i), int(j)] = adj[int(j), int(i)] = int(t)
    return adj


def _valencies(mol) -> np.ndarray:
    adj = _dense_adj(mol).astype(np.float64)
    adj[adj == AROMATIC_BOND] = 1.5
    return adj.sum(0)


def dataset_statistics(mols: Sequence, num_atom_types: int,
                       n_bond_types: int = 5) -> Dict:
    """Target histograms from a reference set: node counts, atom/bond type
    distributions, per-type charge table, per-type valency counters,
    per-bond-type length counters, per-type angle histogram."""
    node_counts: Counter = Counter()
    atom_types = np.zeros(num_atom_types)
    bond_types = np.zeros(n_bond_types)
    charges = np.zeros((num_atom_types, N_CHARGE_BINS))
    valencies: Dict[int, Counter] = {i: Counter()
                                     for i in range(num_atom_types)}
    bond_lengths: Dict[int, Counter] = {t: Counter()
                                        for t in range(1, n_bond_types)}
    angles = np.zeros((num_atom_types, ANGLE_BINS))
    for mol in mols:
        node_counts[mol.seq_length] += 1
        for t in mol.atomics:
            atom_types[int(t)] += 1
        adj = _dense_adj(mol)
        iu = np.triu_indices(mol.seq_length, 1)
        for t in adj[iu]:
            bond_types[int(t)] += 1
        ch = (mol.charges if mol.charges is not None
              else np.zeros(mol.seq_length, np.int64))
        for t, c in zip(mol.atomics, ch):
            charges[int(t), int(np.clip(c + CHARGE_OFFSET, 0,
                                        N_CHARGE_BINS - 1))] += 1
        for t, v in zip(mol.atomics, _valencies(mol)):
            valencies[int(t)][float(v)] += 1
        _accumulate_lengths(mol, adj, bond_lengths)
        _accumulate_angles(mol, adj, angles)
    return {"node_counts": node_counts, "atom_types": atom_types,
            "bond_types": bond_types, "charges": charges,
            "valencies": valencies, "bond_lengths": bond_lengths,
            "angles": angles}


def _accumulate_lengths(mol, adj, out: Dict[int, Counter]):
    pos = np.asarray(mol.coords, np.float64)
    for (i, j), t in zip(mol.bond_indices, mol.bond_types):
        t = int(t)
        if t in out:
            d = round(float(np.linalg.norm(pos[int(i)] - pos[int(j)])), 2)
            out[t][d] += 1


def _accumulate_angles(mol, adj, out: np.ndarray):
    pos = np.asarray(mol.coords, np.float64)
    for a in range(mol.seq_length):
        nbrs = np.nonzero(adj[a])[0]
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                v1 = pos[nbrs[x]] - pos[a]
                v2 = pos[nbrs[y]] - pos[a]
                n1 = np.linalg.norm(v1) + 1e-6
                n2 = np.linalg.norm(v2) + 1e-6
                cosang = np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0)
                deg = round(np.degrees(np.arccos(cosang)), 1)
                out[int(mol.atomics[a]), int(deg * 10)] += 1


def number_nodes_distance(mols, node_counts: Counter) -> float:
    gen: Counter = Counter(m.seq_length for m in mols)
    n = max(max(gen), max(node_counts)) + 1
    g, t = np.zeros(n), np.zeros(n)
    for k, v in gen.items():
        g[k] = v
    for k, v in node_counts.items():
        t[k] = v
    return histogram_w1(g, t)


def atom_types_distance(mols, target: np.ndarray) -> float:
    gen = np.zeros_like(target)
    for m in mols:
        for t in m.atomics:
            gen[int(t)] += 1
    return total_variation1d(gen, target)


def bond_types_distance(mols, target: np.ndarray):
    gen = np.zeros_like(target)
    for m in mols:
        adj = _dense_adj(m)
        iu = np.triu_indices(m.seq_length, 1)
        for t in adj[iu]:
            gen[int(t)] += 1
    sparsity = float(gen[0] / max(gen.sum(), 1.0))
    return total_variation1d(gen, target), sparsity


def charge_distance(mols, target: np.ndarray,
                    atom_probs: np.ndarray) -> float:
    """Per-atom-type charge-CDF W1, weighted by atom-type probability
    (molecular_metrics.py:283-305)."""
    gen = np.zeros_like(target, np.float64)
    for m in mols:
        ch = (m.charges if m.charges is not None
              else np.zeros(m.seq_length, np.int64))
        for t, c in zip(m.atomics, ch):
            gen[int(t), int(np.clip(c + CHARGE_OFFSET, 0,
                                    N_CHARGE_BINS - 1))] += 1
    cs_g = np.cumsum(_normalize(gen), -1)
    cs_t = np.cumsum(_normalize(np.asarray(target, np.float64)), -1)
    w1_per_class = np.abs(cs_g - cs_t).sum(-1)
    return float((w1_per_class * atom_probs).sum())


def valency_distance(mols, target_valencies: Dict[int, Counter],
                     atom_probs: np.ndarray) -> float:
    num_types = len(atom_probs)
    gen: Dict[int, Counter] = {i: Counter() for i in range(num_types)}
    for m in mols:
        for t, v in zip(m.atomics, _valencies(m)):
            gen[int(t)][float(v)] += 1
    max_val = 0.0
    for d in list(target_valencies.values()) + list(gen.values()):
        if d:
            max_val = max(max_val, max(d))
    bins = int(2 * max_val) + 1  # 0.5 steps cover aromatic 1.5 valencies
    g = np.zeros((num_types, bins))
    t = np.zeros((num_types, bins))
    for i in range(num_types):
        for v, c in gen[i].items():
            g[i, int(2 * v)] = c
        for v, c in target_valencies.get(i, {}).items():
            t[i, int(2 * v)] = c
    cs = np.abs(np.cumsum(_normalize(g), -1)
                - np.cumsum(_normalize(t), -1)).sum(-1) * 0.5
    return float((cs * atom_probs).sum())


def bond_length_distance(mols, target: Dict[int, Counter],
                         bond_probs: np.ndarray) -> float:
    """Per-bond-type length-CDF W1 over 0.01 A bins, weighted by bond-type
    probability (molecular_metrics.py:351-398)."""
    n_types = len(bond_probs)
    gen: Dict[int, Counter] = {t: Counter() for t in range(1, n_types)}
    for m in mols:
        _accumulate_lengths(m, None, gen)
    all_d = [d for c in list(gen.values()) + list(target.values())
             for d in c]
    if not all_d:
        return float("nan")
    lo, hi = min(all_d), max(all_d)
    bins = int(round((hi - lo) * 100)) + 1
    g = np.zeros((n_types - 1, bins))
    t = np.zeros((n_types - 1, bins))
    for bt in range(1, n_types):
        for d, c in gen[bt].items():
            g[bt - 1, int(round((d - lo) * 100))] = c
        for d, c in target.get(bt, {}).items():
            t[bt - 1, int(round((d - lo) * 100))] = c
    w1 = np.abs(np.cumsum(_normalize(g), -1)
                - np.cumsum(_normalize(t), -1)).sum(-1) / 100.0
    return float((w1 * bond_probs[1:]).sum())


def angle_distance(mols, target_angles: np.ndarray, atom_probs: np.ndarray,
                   target_valencies: Dict[int, Counter]) -> float:
    """Per-atom-type bond-angle-CDF W1 over 0.1-degree bins; atom types
    that are mostly valency<2 in the dataset are down-weighted
    (molecular_metrics.py:400-452)."""
    num_types = len(atom_probs)
    gen = np.zeros((num_types, ANGLE_BINS))
    for m in mols:
        _accumulate_angles(m, _dense_adj(m), gen)
    cs = np.abs(np.cumsum(_normalize(gen), -1)
                - np.cumsum(_normalize(np.asarray(target_angles,
                                                  np.float64)), -1))
    w1_per_type = cs.sum(-1) / 10.0
    val_weight = np.zeros(num_types)
    for i in range(num_types):
        c = target_valencies.get(i, Counter())
        total = sum(c.values()) or 1
        frac_lt2 = (c.get(0.0, 0) + c.get(1.0, 0)) / total
        val_weight[i] = 1.0 - frac_lt2
    denom = (atom_probs * val_weight).sum() + 1e-5
    return float((w1_per_type * atom_probs * val_weight).sum() / denom)


def midi_sampling_metrics(gen_mols: List, ref_mols: List,
                          num_atom_types: int,
                          n_bond_types: int = 5) -> Dict[str, float]:
    """The MiDi SamplingMetrics distance block
    (molecular_metrics.py:146-239) with targets computed from `ref_mols`."""
    stats = dataset_statistics(ref_mols, num_atom_types, n_bond_types)
    atom_probs = _normalize(stats["atom_types"])
    bond_probs = _normalize(stats["bond_types"])
    bond_tv, sparsity = bond_types_distance(gen_mols, stats["bond_types"])
    return {
        "NumNodesW1": number_nodes_distance(gen_mols, stats["node_counts"]),
        "AtomTypesTV": atom_types_distance(gen_mols, stats["atom_types"]),
        "EdgeTypesTV": bond_tv,
        "sparsity_level": sparsity,
        "ChargeW1": charge_distance(gen_mols, stats["charges"], atom_probs),
        "ValencyW1": valency_distance(gen_mols, stats["valencies"],
                                      atom_probs),
        "BondLengthsW1": bond_length_distance(gen_mols,
                                              stats["bond_lengths"],
                                              bond_probs),
        "AnglesW1": angle_distance(gen_mols, stats["angles"], atom_probs,
                                   stats["valencies"]),
    }
