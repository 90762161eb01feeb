"""Synthetic data with a learnable rule, for convergence runs. The port's
copy of reed_tpu/data/synthetic.py (numpy): the molecule families (rigid
QM9 templates and the 1,089 decorated heavy-atom chains, each a rigid body
under a random rotation), the protein rule batch, the MultiFlow ideal-helix
codesign batch and the RDM's class-conditional Gaussian reps. For one numpy seed
every function returns the same arrays as reed_tpu's."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Rigid molecule templates (QM9 atom set: H,C,N,O,F). Geometry from standard
# experimental bond lengths/angles; every atom sits at its exact allowed
# valence under eval/molecule_metrics.get_bond_order.
# --------------------------------------------------------------------------

_T = 1.09 / np.sqrt(3.0)  # methane C-H tetrahedral component

# NH3: N-H 1.01 A, H-N-H 107 deg -> polar angle alpha with
# cos(theta_HH) = 1 - 1.5 sin^2(alpha)
_NH3_SIN = np.sqrt((1.0 - np.cos(np.deg2rad(107.0))) / 1.5)
_NH3_COS = np.sqrt(1.0 - _NH3_SIN ** 2)
_H2O_ANG = np.deg2rad(104.5 / 2.0)

# atom type indices into QM9_ATOM_DECODER = [H, C, N, O, F]
MOLECULE_TEMPLATES: List[Dict] = [
    {
        "name": "CH4",
        "types": np.array([1, 0, 0, 0, 0]),          # C H H H H
        "charges": np.array([6, 1, 1, 1, 1], np.float32),
        "coords": np.array([
            [0.0, 0.0, 0.0],
            [_T, _T, _T],
            [_T, -_T, -_T],
            [-_T, _T, -_T],
            [-_T, -_T, _T],
        ], np.float32),
        # all-order-1 bond graph (heavy atom first)
        "bonds": [(0, 1, 1), (0, 2, 1), (0, 3, 1), (0, 4, 1)],
    },
    {
        "name": "NH3",
        "types": np.array([2, 0, 0, 0]),             # N H H H
        "charges": np.array([7, 1, 1, 1], np.float32),
        "coords": np.array(
            [[0.0, 0.0, 0.0]]
            + [[1.01 * _NH3_SIN * np.cos(p), 1.01 * _NH3_SIN * np.sin(p),
                -1.01 * _NH3_COS]
               for p in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)],
            np.float32),
        "bonds": [(0, 1, 1), (0, 2, 1), (0, 3, 1)],
    },
    {
        "name": "H2O",
        "types": np.array([3, 0, 0]),                # O H H
        "charges": np.array([8, 1, 1], np.float32),
        "coords": np.array([
            [0.0, 0.0, 0.0],
            [0.96 * np.cos(_H2O_ANG), 0.96 * np.sin(_H2O_ANG), 0.0],
            [0.96 * np.cos(_H2O_ANG), -0.96 * np.sin(_H2O_ANG), 0.0],
        ], np.float32),
        "bonds": [(0, 1, 1), (0, 2, 1)],
    },
    {
        "name": "HF",
        "types": np.array([4, 0]),                   # F H
        "charges": np.array([9, 1], np.float32),
        "coords": np.array([[0.0, 0.0, 0.0], [0.92, 0.0, 0.0]], np.float32),
        "bonds": [(0, 1, 1)],
    },
]

TEMPLATE_MAX_ATOMS = max(len(t["types"]) for t in MOLECULE_TEMPLATES)
TEMPLATE_NUM_TYPES = 5


def _random_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniform random rotation matrices via normalized quaternions [n,3,3]."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, i, j, k = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        1 - 2 * (j ** 2 + k ** 2), 2 * (i * j - k * w), 2 * (i * k + j * w),
        2 * (i * j + k * w), 1 - 2 * (i ** 2 + k ** 2), 2 * (j * k - i * w),
        2 * (i * k - j * w), 2 * (j * k + i * w), 1 - 2 * (i ** 2 + j ** 2),
    ], axis=-1).reshape(n, 3, 3)


def template_molecule_batch(
    rng: np.random.Generator,
    batch_size: int,
    max_nodes: int = TEMPLATE_MAX_ATOMS,
    templates: Optional[Sequence[Dict]] = None,
) -> Dict[str, np.ndarray]:
    """Sample randomly-rotated zero-CoM template molecules, padded to
    `max_nodes`. Returns coords [B,N,3], types [B,N] (QM9 decoder indices),
    charges [B,N] (atomic numbers), bond_orders [B,N,N], mask [B,N]."""
    templates = list(templates if templates is not None else MOLECULE_TEMPLATES)
    idx = rng.integers(0, len(templates), size=batch_size)
    rots = _random_rotations(rng, batch_size)
    coords = np.zeros((batch_size, max_nodes, 3), np.float32)
    types = np.zeros((batch_size, max_nodes), np.int64)
    charges = np.zeros((batch_size, max_nodes), np.float32)
    orders = np.zeros((batch_size, max_nodes, max_nodes), np.int64)
    mask = np.zeros((batch_size, max_nodes), np.float32)
    for b, ti in enumerate(idx):
        t = templates[ti]
        n = len(t["types"])
        xyz = t["coords"] - t["coords"].mean(axis=0, keepdims=True)
        coords[b, :n] = xyz @ rots[b].T
        types[b, :n] = t["types"]
        charges[b, :n] = t["charges"]
        mask[b, :n] = 1.0
        for i, j, o in t["bonds"]:
            orders[b, i, j] = orders[b, j, i] = o
    return {"coords": coords, "types": types, "charges": charges,
            "bond_orders": orders, "mask": mask, "template_idx": idx}


def template_size_histogram(
        templates: Optional[Sequence[Dict]] = None) -> Dict[int, float]:
    templates = list(templates if templates is not None else MOLECULE_TEMPLATES)
    hist: Dict[int, float] = {}
    for t in templates:
        hist[len(t["types"])] = hist.get(len(t["types"]), 0.0) + 1.0
    return hist


# --------------------------------------------------------------------------
# Decorated heavy-atom chains: a molecule family with real combinatorial
# entropy (1,089 classes / ~580 distinct bond graphs after reversal
# symmetry) so convergence runs can prove validity
# AND uniqueness/diversity — the 4 rigid templates above cap uniqueness at
# ~4/n_eval (the model memorizes them), whereas the reference's val metrics
# track uniqueness of the generated set
# (molecule/semlaflow/flowmodels/fm.py:677-693).
#
# A class = (chain length h in 2..6, heavy types in {C,N,O}^h). Geometry is
# DETERMINISTIC per class: heavy atoms on an ideal tetrahedral zigzag with
# textbook single-bond lengths, hydrogens completing each valence on exact
# sp3 directions. Every class is a rigid body (like the templates), so the
# family stays learnable, but there are sum_h 3^h = 1,089 of them.
# --------------------------------------------------------------------------

CHAIN_HEAVY_TYPES = (1, 2, 3)        # QM9 decoder indices: C, N, O
CHAIN_VALENCE = {1: 4, 2: 3, 3: 2}   # C4 N3 O2
CHAIN_ATOMIC_NUM = {0: 1, 1: 6, 2: 7, 3: 8}
CHAIN_MIN_HEAVY, CHAIN_MAX_HEAVY = 2, 6
# single-bond lengths (Angstrom) = eval/molecule_metrics BONDS1 centers
_HEAVY_BOND = {(1, 1): 1.54, (1, 2): 1.47, (1, 3): 1.43,
               (2, 2): 1.45, (2, 3): 1.40, (3, 3): 1.48}
_H_BOND = {1: 1.09, 2: 1.01, 3: 0.96}
_TET = np.deg2rad(109.4712)          # ideal sp3 angle

# h + max hydrogens (all-carbon chain): 6 + (3+2+2+2+2+3) = 20
CHAIN_MAX_ATOMS = CHAIN_MAX_HEAVY + (2 * 3 + (CHAIN_MAX_HEAVY - 2) * 2)


def _chain_class(heavy_types: Tuple[int, ...]) -> Dict:
    """Deterministic rigid conformer for one chain class."""
    h = len(heavy_types)
    theta = (np.pi - _TET) / 2.0
    pos = [np.zeros(3)]
    for i in range(h - 1):
        pair = tuple(sorted((heavy_types[i], heavy_types[i + 1])))
        d = np.array([np.cos(theta), ((-1.0) ** i) * np.sin(theta), 0.0])
        pos.append(pos[-1] + _HEAVY_BOND[pair] * d)
    pos = np.stack(pos)

    coords = list(pos)
    types = list(heavy_types)
    bonds = [(i, i + 1, 1) for i in range(h - 1)]
    for i, t in enumerate(heavy_types):
        deg = 1 if i in (0, h - 1) else 2
        n_h = CHAIN_VALENCE[t] - deg
        if n_h <= 0:
            continue
        if i == 0:
            nbrs = [pos[1] - pos[0]]
        elif i == h - 1:
            nbrs = [pos[h - 2] - pos[h - 1]]
        else:
            nbrs = [pos[i - 1] - pos[i], pos[i + 1] - pos[i]]
        nbrs = [v / np.linalg.norm(v) for v in nbrs]
        if len(nbrs) == 2:
            u1, u2 = nbrs
            b = -(u1 + u2)
            b /= np.linalg.norm(b)
            w = np.cross(u1, u2)
            w /= np.linalg.norm(w)
            dirs = [b * np.cos(_TET / 2) + w * np.sin(_TET / 2),
                    b * np.cos(_TET / 2) - w * np.sin(_TET / 2)][:n_h]
        else:
            u1 = nbrs[0]
            a = np.cross(u1, np.array([0.0, 0.0, 1.0]))
            if np.linalg.norm(a) < 1e-6:
                a = np.cross(u1, np.array([0.0, 1.0, 0.0]))
            a /= np.linalg.norm(a)
            b2 = np.cross(u1, a)
            dirs = [u1 * np.cos(_TET)
                    + (a * np.cos(p) + b2 * np.sin(p)) * np.sin(_TET)
                    for p in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)][:n_h]
        for dvec in dirs:
            bonds.append((i, len(coords), 1))
            coords.append(pos[i] + _H_BOND[t] * dvec)
            types.append(0)

    coords = np.asarray(coords, np.float32)
    coords -= coords.mean(axis=0, keepdims=True)
    return {
        "name": "chain-" + "".join(QM9_SYMBOLS[t] for t in heavy_types),
        "types": np.asarray(types, np.int64),
        "charges": np.asarray([CHAIN_ATOMIC_NUM[t] for t in types],
                              np.float32),
        "coords": coords,
        "bonds": bonds,
    }


QM9_SYMBOLS = ["H", "C", "N", "O", "F"]


def chain_classes() -> List[Tuple[int, ...]]:
    """All 1,089 (heavy type sequence) classes, deterministic order."""
    import itertools

    out: List[Tuple[int, ...]] = []
    for h in range(CHAIN_MIN_HEAVY, CHAIN_MAX_HEAVY + 1):
        out.extend(itertools.product(CHAIN_HEAVY_TYPES, repeat=h))
    return out


_CHAIN_CACHE: Dict[Tuple[int, ...], Dict] = {}


def chain_templates() -> List[Dict]:
    """The chain family in MOLECULE_TEMPLATES format (built once)."""
    if not _CHAIN_CACHE:
        for key in chain_classes():
            _CHAIN_CACHE[key] = _chain_class(key)
    return list(_CHAIN_CACHE.values())


def chain_molecule_batch(rng: np.random.Generator, batch_size: int,
                         max_nodes: int = CHAIN_MAX_ATOMS,
                         ) -> Dict[str, np.ndarray]:
    """Randomly-rotated decorated chains, same format as
    template_molecule_batch."""
    return template_molecule_batch(rng, batch_size, max_nodes=max_nodes,
                                   templates=chain_templates())


def chain_size_histogram() -> Dict[int, float]:
    return template_size_histogram(chain_templates())


# --------------------------------------------------------------------------
# Protein sequence<->structure rule
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# Ideal-helix codesign rule (multiflow SE(3))
# --------------------------------------------------------------------------

HELIX_RADIUS = 2.3      # A: canonical alpha-helix Ca ring radius
HELIX_RISE = 1.5        # A per residue
HELIX_TURN = np.deg2rad(100.0)
# consecutive Ca-Ca distance of the trace below:
HELIX_CA_CA = float(np.sqrt((2 * HELIX_RADIUS
                             * np.sin(HELIX_TURN / 2)) ** 2 + HELIX_RISE ** 2))


def helix_ca_trace(length: int) -> np.ndarray:
    """Canonical alpha-helix Ca trace [L,3], zero-CoM; consecutive Ca-Ca
    distance HELIX_CA_CA ~= 3.85 A (the protein-backbone virtual bond)."""
    i = np.arange(length, dtype=np.float32)
    ca = np.stack([HELIX_RADIUS * np.cos(HELIX_TURN * i),
                   HELIX_RADIUS * np.sin(HELIX_TURN * i),
                   HELIX_RISE * i], axis=-1)
    return (ca - ca.mean(axis=0, keepdims=True)).astype(np.float32)


def frames_from_ca(ca: np.ndarray) -> np.ndarray:
    """Gram-Schmidt backbone frames [L,3,3] from a Ca trace [L,3]: column 0
    points along the chain, column 1 is the orthogonalized backward
    direction, column 2 their cross product (det +1). Rotating the trace by
    R rotates every frame by the same R, so the rule is SO(3)-equivariant —
    a flow model scored on rotation loss can learn it exactly."""
    nxt = np.roll(ca, -1, axis=0)
    prv = np.roll(ca, 1, axis=0)
    e1 = nxt - ca
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    v2 = prv - ca
    v2 = v2 - (v2 * e1).sum(-1, keepdims=True) * e1
    e2 = v2 / np.maximum(np.linalg.norm(v2, axis=-1, keepdims=True), 1e-8)
    e3 = np.cross(e1, e2)
    fr = np.stack([e1, e2, e3], axis=-1).astype(np.float32)
    # chain ends have no valid (prv, nxt) pair — copy the adjacent interior
    # frame (still a deterministic, equivariant function of the trace)
    fr[0] = fr[1]
    fr[-1] = fr[-2]
    return fr


def helix_codesign_batch(rng: np.random.Generator, batch_size: int,
                         length: int) -> Dict[str, np.ndarray]:
    """Randomly-rotated ideal helices with the deterministic residue rule
    aatype[i] = i mod 20 — the learnable target for the multiflow SE(3)
    codesign convergence run. A trained model must (a) place consecutive
    Ca's HELIX_CA_CA apart and recover the helix shape to low Kabsch RMSD,
    (b) read the sequence rule out of res_idx (recovery -> 1; untrained
    ~1/20). Same keys as train/multiflow.MultiflowTrainer.synthetic_batch
    (reference: multiflow/data/interpolant.py corrupt_batch inputs)."""
    ca0 = helix_ca_trace(length)
    fr0 = frames_from_ca(ca0)
    rots = _random_rotations(rng, batch_size)
    trans = np.einsum("bij,lj->bli", rots, ca0).astype(np.float32)
    rotmats = np.einsum("bij,ljk->blik", rots, fr0).astype(np.float32)
    aat = np.broadcast_to(np.arange(length) % 20, (batch_size, length))
    return {
        "trans_1": trans,
        "rotmats_1": rotmats,
        "aatypes_1": aat.astype(np.int64).copy(),
        "res_mask": np.ones((batch_size, length), np.float32),
        "res_idx": np.broadcast_to(
            np.arange(length, dtype=np.int32)[None],
            (batch_size, length)).copy(),
    }


# --------------------------------------------------------------------------
# Class-conditional Gaussian reps (RDM latent DDPM)
# --------------------------------------------------------------------------

RDM_CLASS_SIZES = (10, 14, 18, 22)   # num_atoms values keying the classes
RDM_CLASS_SEP = 2.0                  # |mu_k|; pairwise distance 2*sqrt(2)
RDM_CLASS_SIGMA = 0.25               # >> 11-sigma class separation


def rdm_class_means(channels: int) -> np.ndarray:
    """Deterministic well-separated class means [K,C]: orthonormal
    directions (QR of a fixed-seed Gaussian) scaled to RDM_CLASS_SEP."""
    k = len(RDM_CLASS_SIZES)
    g = np.random.default_rng(1234).standard_normal((channels, k))
    q, _ = np.linalg.qr(g)
    return (RDM_CLASS_SEP * q.T[:k]).astype(np.float32)


def rdm_gaussian_batch(rng: np.random.Generator, batch_size: int,
                       channels: int) -> Dict[str, np.ndarray]:
    """Class-conditional Gaussian reps keyed on num_atoms: class k draws
    rep ~ N(mu_k, RDM_CLASS_SIGMA^2 I) with orthogonal means, the learnable
    target of the RDM convergence run (nearest-mean accuracy -> 1 when
    learned, ~1/K untrained)."""
    mus = rdm_class_means(channels)
    k = rng.integers(0, len(RDM_CLASS_SIZES), size=batch_size)
    rep = mus[k] + RDM_CLASS_SIGMA * rng.standard_normal(
        (batch_size, channels)).astype(np.float32)
    return {"rep": rep.astype(np.float32),
            "num_atoms": np.asarray(RDM_CLASS_SIZES, np.int64)[k],
            "class_idx": k}
