"""MOSES-style distribution metrics: SNN / Frag / Scaf / FCD / property
Wasserstein / validity / uniqueness / novelty; the port's counterpart of
reed_tpu/eval/molsets.py.

The counterpart of molecule/eval_src/evaluation/molsets.py (itself adapted
from molecularsets/moses): SNNMetric (average max Tanimoto of Morgan
fingerprints, molsets.py:405-459), FragMetric / ScafMetric (cosine similarity
of BRICS-fragment / Murcko-scaffold count dicts, molsets.py:462-492),
WassersteinMetric over logP/SA/QED/weight (molsets.py:494-510), FCD
(molsets.py:6, fcd_torch), and the valid/unique/novelty fractions
(molsets.py:331-378).

Design notes:
- the O(N_ref x N_gen) Tanimoto similarity is one dense product, f32 with
  TF32 off, on the device the caller names (CUDA unless the caller asks for
  the CPU) instead of the reference's batched torch.mm loop
  (molsets.py:422-459).
- RDKit is not in this image: fingerprints fall back to a from-scratch
  ECFP-style circular hash over the molecular graph (same construction as
  Morgan fingerprints: iterated neighborhood hashing of atom invariants),
  fragments to bond-environment hashes, scaffolds to the ring-skeleton graph
  hash (iteratively strip degree-1 atoms = Murcko's procedure on the graph).
  With RDKit present the exact reference featurizers are used.
- FCD requires the ChemNet torch weights (fcd_torch, or a converted state
  dict for eval/chemnet); returns None when neither is available.

Molecules enter as the port's `data.molecule.GeometricMol` records (or
RDKit mols when RDKit is available).
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.encoders.flax_tree import full_f32

try:  # pragma: no cover - not in this image
    from rdkit import Chem

    HAVE_RDKIT = True
except ImportError:
    Chem = None
    HAVE_RDKIT = False

try:  # pragma: no cover - not in this image
    import fcd_torch  # noqa: F401

    HAVE_FCD = True
except ImportError:
    HAVE_FCD = False

# atomic masses for the RDKit-free weight metric
ATOMIC_MASS = {"H": 1.008, "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999,
               "F": 18.998, "Al": 26.982, "Si": 28.085, "P": 30.974,
               "S": 32.06, "Cl": 35.45, "As": 74.922, "Br": 79.904,
               "I": 126.904, "Hg": 200.592, "Bi": 208.980}


def _hash32(data: str) -> int:
    return int.from_bytes(hashlib.blake2b(data.encode(),
                                          digest_size=4).digest(), "little")


def _adjacency(mol) -> List[List[tuple]]:
    """[(neighbor, bond_type)] per atom from a GeometricMol."""
    adj: List[List[tuple]] = [[] for _ in range(mol.seq_length)]
    for (i, j), t in zip(mol.bond_indices, mol.bond_types):
        adj[int(i)].append((int(j), int(t)))
        adj[int(j)].append((int(i), int(t)))
    return adj


def circular_identifiers(mol, radius: int = 2,
                         vocab_tokens: Optional[Sequence[str]] = None
                         ) -> List[int]:
    """ECFP-style circular substructure identifiers of a molecular graph:
    start from atom invariants (element, degree, charge) and iteratively
    hash sorted (bond, neighbor-id) lists — the Morgan algorithm
    (reference fingerprints use RDKit's implementation, molsets.py:196-225).
    Returns all identifiers across radii 0..radius."""
    n = mol.seq_length
    adj = _adjacency(mol)
    charges = (mol.charges if mol.charges is not None
               else np.zeros(n, np.int64))
    ids = [_hash32(f"a{int(t)}d{len(adj[i])}c{int(charges[i])}")
           for i, t in enumerate(mol.atomics)]
    out = list(ids)
    for _ in range(radius):
        nxt = []
        for i in range(n):
            env = sorted((t, ids[j]) for j, t in adj[i])
            nxt.append(_hash32(f"{ids[i]}|{env}"))
        ids = nxt
        out.extend(ids)
    return out


def fingerprints(mols, n_bits: int = 1024, radius: int = 2) -> np.ndarray:
    """[N, n_bits] binary Morgan(-style) fingerprints."""
    if HAVE_RDKIT and mols and not hasattr(mols[0], "bond_indices"):
        from rdkit.Chem.AllChem import (
            GetMorganFingerprintAsBitVect as Morgan)

        return np.array([np.array(Morgan(m, radius, n_bits))
                         for m in mols], np.float32)
    fps = np.zeros((len(mols), n_bits), np.float32)
    for k, mol in enumerate(mols):
        for ident in circular_identifiers(mol, radius):
            fps[k, ident % n_bits] = 1.0
    return fps


@full_f32
def average_agg_tanimoto(ref_fps: np.ndarray, gen_fps: np.ndarray, agg: str = "max",
                         p: float = 1.0, device=None) -> float:
    """For each generated fingerprint, the max (or mean) Tanimoto similarity
    to the reference set; averaged (reference molsets.py:422-459). One f32
    product on `device` instead of torch.mm batches."""
    device = resolve_device(device)
    r = torch.as_tensor(ref_fps, dtype=torch.float32).to(device)
    g = torch.as_tensor(gen_fps, dtype=torch.float32).to(device)
    tp = r @ g.T                                       # [Nr, Ng]
    union = r.sum(1, keepdim=True) + g.sum(1)[None] - tp
    jac = torch.where(union > 0, tp / torch.clamp(union, min=1e-8), 1.0)
    if p != 1.0:
        jac = jac ** p
    agg_v = jac.max(0).values if agg == "max" else jac.mean(0)
    if p != 1.0:
        agg_v = agg_v ** (1.0 / p)
    return float(agg_v.mean())


def fragment_counts(mols) -> Counter:
    """BRICS fragment counts with RDKit; bond-environment hash counts
    otherwise (each bond with its two radius-1 atom environments — a
    fragment-shaped decomposition of the graph)."""
    if HAVE_RDKIT and mols and not hasattr(mols[0], "bond_indices"):
        from rdkit.Chem import AllChem

        frags = Counter()
        for m in mols:
            frags.update(AllChem.FragmentOnBRICSBonds(m) and [
                Chem.MolToSmiles(f) for f in
                Chem.GetMolFrags(AllChem.FragmentOnBRICSBonds(m),
                                 asMols=True)])
        return frags
    counts: Counter = Counter()
    for mol in mols:
        ids = circular_identifiers(mol, radius=1)
        n = mol.seq_length
        r1 = ids[n:2 * n] if len(ids) >= 2 * n else ids[:n]
        for (i, j), t in zip(mol.bond_indices, mol.bond_types):
            a, b = sorted((r1[int(i)], r1[int(j)]))
            counts[_hash32(f"{a}-{int(t)}-{b}")] += 1
    return counts


def _strip_to_scaffold(mol):
    """Murcko's procedure on the raw graph: iteratively remove degree-1
    atoms until only ring systems + linkers remain. Returns kept indices."""
    n = mol.seq_length
    deg = np.zeros(n, np.int64)
    adj = [set() for _ in range(n)]
    for (i, j) in mol.bond_indices:
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    for i in range(n):
        deg[i] = len(adj[i])
    alive = np.ones(n, bool)
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if alive[i] and deg[i] <= 1:
                alive[i] = False
                changed = True
                for j in adj[i]:
                    if alive[j]:
                        deg[j] -= 1
                adj[i] = set()
    return np.where(alive)[0]


def scaffold_counts(mols, min_rings: int = 1) -> Counter:
    """Murcko scaffold counts: RDKit MurckoScaffold when available
    (molsets.py:170-193), else a WL-hash of the stripped ring skeleton."""
    if HAVE_RDKIT and mols and not hasattr(mols[0], "bond_indices"):
        from rdkit.Chem.Scaffolds import MurckoScaffold

        return Counter(
            Chem.MolToSmiles(MurckoScaffold.GetScaffoldForMol(m))
            for m in mols)
    counts: Counter = Counter()
    for mol in mols:
        kept = _strip_to_scaffold(mol)
        if len(kept) == 0:
            continue
        remap = {int(v): k for k, v in enumerate(kept)}
        # WL hash of the induced skeleton (2 rounds)
        ids = [_hash32(f"s{int(mol.atomics[v])}") for v in kept]
        adj: List[List[tuple]] = [[] for _ in kept]
        for (i, j), t in zip(mol.bond_indices, mol.bond_types):
            i, j = int(i), int(j)
            if i in remap and j in remap:
                adj[remap[i]].append((remap[j], int(t)))
                adj[remap[j]].append((remap[i], int(t)))
        for _ in range(2):
            ids = [_hash32(f"{ids[k]}|{sorted((t, ids[j]) for j, t in adj[k])}")
                   for k in range(len(kept))]
        counts[_hash32(str(sorted(ids)))] += 1
    return counts


def cos_similarity(ref_counts: Counter, gen_counts: Counter) -> float:
    """Cosine similarity between count dicts (molsets.py:462-475)."""
    if not ref_counts or not gen_counts:
        return float("nan")
    keys = set(ref_counts) | set(gen_counts)
    r = np.array([ref_counts.get(k, 0) for k in keys], np.float64)
    g = np.array([gen_counts.get(k, 0) for k in keys], np.float64)
    denom = np.linalg.norm(r) * np.linalg.norm(g)
    return float(r @ g / denom) if denom > 0 else float("nan")


def wasserstein_1d(a: Sequence[float], b: Sequence[float]) -> float:
    """W1 between empirical distributions via the quantile integral."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    q = np.linspace(0, 1, max(len(a), len(b), 2) * 2 + 1)[1::2]
    qa = np.quantile(a, q)
    qb = np.quantile(b, q)
    return float(np.abs(qa - qb).mean())


def molecular_weight(mol, vocab_tokens: Sequence[str]) -> float:
    return float(sum(ATOMIC_MASS.get(vocab_tokens[int(t)], 0.0)
                     for t in mol.atomics))


def mol_hash(mol) -> int:
    """Canonical graph hash for uniqueness/novelty without RDKit."""
    ids = circular_identifiers(mol, radius=3)
    n = mol.seq_length
    return _hash32(str(sorted(ids[-n:])))


def fcd(gen_smiles, ref_smiles, chemnet_params=None, device=None) -> Optional[float]:
    """Frechet ChemNet Distance (reference: molsets.py:6, fcd_torch).

    The LSTM and the statistic are in the repository (eval/chemnet.py):
    pass `chemnet_params` (a ChemNet state dict converted by
    chemnet.convert_torch_chemnet) to run without fcd_torch, on `device`;
    only the pretrained weight file itself is not in the repository. Else
    fcd_torch where it imports; None when neither is available."""
    if chemnet_params is not None:
        from reed_tpu_torch.eval.chemnet import fcd_score

        return fcd_score(chemnet_params, list(gen_smiles), list(ref_smiles), device=device)
    if not HAVE_FCD:
        return None
    from fcd_torch import FCD

    return float(FCD(device="cpu")(gen=list(gen_smiles),
                                   ref=list(ref_smiles)))


def geometric_mols_from_samples(samples, atom_decoder: Sequence[str],
                                dataset: str = "qm9") -> List:
    """[(positions, atom_types), ...] sampler outputs -> GeometricMol with
    distance-inferred bond orders (reference builds rdkit mols the same way,
    eval_src/eval_utils.py via rdkit_functions.build_molecule)."""
    from reed_tpu_torch.data.molecule import GeometricMol
    from reed_tpu_torch.eval.molecule_metrics import build_bond_graph

    out = []
    for pos, types in samples:
        orders = build_bond_graph(pos, types, atom_decoder, dataset)
        idx = np.argwhere(np.triu(orders, 1) > 0)
        bond_types = orders[idx[:, 0], idx[:, 1]] if len(idx) else \
            np.zeros((0,), np.int32)
        out.append(GeometricMol(
            coords=np.asarray(pos, np.float32),
            atomics=np.asarray(types, np.int32),
            bond_indices=idx.astype(np.int32),
            bond_types=np.asarray(bond_types, np.int32),
            charges=np.zeros(len(types), np.int32)))
    return out


def moses_metrics(gen_mols, test_mols, train_mols=None,
                  vocab_tokens: Optional[Sequence[str]] = None,
                  n_bits: int = 1024, device=None) -> Dict[str, Optional[float]]:
    """The MOSES metric block of the reference eval
    (molsets.py:542-607 get_all_metrics): SNN/Frag/Scaf vs the test set (the
    SNN product on `device`), weight Wasserstein, uniqueness, novelty vs
    train, FCD when available."""
    from reed_tpu_torch.data.molecule import build_vocab

    vocab_tokens = vocab_tokens or build_vocab().tokens
    out: Dict[str, Optional[float]] = {}

    gen_fp = fingerprints(gen_mols, n_bits)
    test_fp = fingerprints(test_mols, n_bits)
    out["SNN/Test"] = average_agg_tanimoto(test_fp, gen_fp, device=device)
    out["Frag/Test"] = cos_similarity(fragment_counts(test_mols),
                                      fragment_counts(gen_mols))
    out["Scaf/Test"] = cos_similarity(scaffold_counts(test_mols),
                                      scaffold_counts(gen_mols))
    out["weight"] = wasserstein_1d(
        [molecular_weight(m, vocab_tokens) for m in gen_mols],
        [molecular_weight(m, vocab_tokens) for m in test_mols])

    hashes = [mol_hash(m) for m in gen_mols]
    out["unique"] = len(set(hashes)) / max(len(hashes), 1)
    if train_mols is not None:
        train_hashes = {mol_hash(m) for m in train_mols}
        out["Novelty"] = (sum(h not in train_hashes for h in hashes)
                          / max(len(hashes), 1))
    if HAVE_RDKIT and gen_mols and not hasattr(gen_mols[0], "bond_indices"):
        out["FCD/Test"] = fcd([Chem.MolToSmiles(m) for m in gen_mols],
                              [Chem.MolToSmiles(m) for m in test_mols], device=device)
    else:
        out["FCD/Test"] = None
    return out
