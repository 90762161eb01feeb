"""Molecule metrics, the port's copy of reed_tpu/eval/molecule_metrics.py
(host-side numpy): the bond length and valence tables, distance-inferred
bond orders, EDM's MoleculeMetrics (atom / molecule stability, validity,
uniqueness and novelty over bonds inferred from distances, reference
qm9/analyze.py) with check_stability and the size histogram sampler
DistributionNodes, SemlaFlow's GraphMoleculeMetrics (the same over
PREDICTED graphs, with charge-aware valences and fc-validity),
PoseBusters-style geometry checks, the relaxed validity, the MMFF94
energies (rdkit only) and the size-binned property sampler
DistributionProperty. RDKit-dependent paths run where rdkit imports;
without it the table-driven fallbacks run, as in reed_tpu (`HAVE_RDKIT`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from rdkit import Chem  # pragma: no cover - not in this image

    HAVE_RDKIT = True
except ImportError:
    Chem = None
    HAVE_RDKIT = False

# Bond length tables in picometers (reference: qm9/bond_analyze.py:1-47)
BONDS1 = {
    "H": {"H": 74, "C": 109, "N": 101, "O": 96, "F": 92, "B": 119, "Si": 148,
          "P": 144, "As": 152, "S": 134, "Cl": 127, "Br": 141, "I": 161},
    "C": {"H": 109, "C": 154, "N": 147, "O": 143, "F": 135, "Si": 185,
          "P": 184, "S": 182, "Cl": 177, "Br": 194, "I": 214},
    "N": {"H": 101, "C": 147, "N": 145, "O": 140, "F": 136, "Cl": 175,
          "Br": 214, "S": 168, "I": 222, "P": 177},
    "O": {"H": 96, "C": 143, "N": 140, "O": 148, "F": 142, "Br": 172,
          "S": 151, "P": 163, "Si": 163, "Cl": 164, "I": 194},
    "F": {"H": 92, "C": 135, "N": 136, "O": 142, "F": 142, "S": 158,
          "Si": 160, "Cl": 166, "Br": 178, "P": 156, "I": 187},
    "B": {"H": 119, "Cl": 175},
    "Si": {"Si": 233, "H": 148, "C": 185, "O": 163, "S": 200, "F": 160,
           "Cl": 202, "Br": 215, "I": 243},
    "Cl": {"Cl": 199, "H": 127, "C": 177, "N": 175, "O": 164, "P": 203,
           "S": 207, "B": 175, "Si": 202, "F": 166, "Br": 214},
    "S": {"H": 134, "C": 182, "N": 168, "O": 151, "S": 204, "F": 158,
          "Cl": 207, "Br": 225, "Si": 200, "P": 210, "I": 234},
    "Br": {"Br": 228, "H": 141, "C": 194, "O": 172, "N": 214, "Si": 215,
           "S": 225, "F": 178, "Cl": 214, "P": 222},
    "P": {"P": 221, "H": 144, "C": 184, "O": 163, "Cl": 203, "S": 210,
          "F": 156, "N": 177, "Br": 222},
    "I": {"H": 161, "C": 214, "Si": 243, "N": 222, "O": 194, "S": 234,
          "F": 187, "I": 266},
    "As": {"H": 152},
}
BONDS2 = {"C": {"C": 134, "N": 129, "O": 120, "S": 160},
          "N": {"C": 129, "N": 125, "O": 121},
          "O": {"C": 120, "N": 121, "O": 121, "P": 150},
          "P": {"O": 150, "S": 186},
          "S": {"P": 186}}
BONDS3 = {"C": {"C": 120, "N": 116, "O": 113},
          "N": {"C": 116, "N": 110},
          "O": {"C": 113}}
MARGIN1, MARGIN2, MARGIN3 = 10, 5, 3

ALLOWED_BONDS = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3, "Si": 4,
    "P": [3, 5], "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1, "Hg": [1, 2],
    "Bi": [3, 5],
}

QM9_ATOM_DECODER = ["H", "C", "N", "O", "F"]
GEOM_ATOM_DECODER = ["H", "B", "C", "N", "O", "F", "Al", "Si", "P", "S",
                     "Cl", "As", "Br", "I", "Hg", "Bi"]

# valence ranges once formal charges are allowed (N+ 4, O- 1, etc.) for the
# relaxed-validity check (reference builds rdkit mols with partial charges,
# qm9/rdkit_functions.py:271-286 build_molecule_with_partial_charges)
CHARGED_VALENCES = {
    "H": (1, 1), "C": (3, 4), "N": (2, 4), "O": (1, 3), "F": (1, 1),
    "B": (3, 4), "Al": (3, 4), "Si": (4, 4), "P": (3, 5), "S": (2, 6),
    "Cl": (1, 1), "As": (3, 5), "Br": (1, 1), "I": (1, 1), "Hg": (1, 2),
    "Bi": (3, 5),
}

# single-bond covalent radii in Angstrom (Pyykko & Atsumi 2009) for the
# steric-clash check
COVALENT_RADII = {"H": 0.32, "B": 0.85, "C": 0.75, "N": 0.71, "O": 0.63,
                  "F": 0.64, "Al": 1.26, "Si": 1.16, "P": 1.11, "S": 1.03,
                  "Cl": 0.99, "As": 1.21, "Br": 1.14, "I": 1.33,
                  "Hg": 1.33, "Bi": 1.51}


def get_bond_order(atom1: str, atom2: str, distance: float,
                   check_exists: bool = False) -> int:
    """Distance (Angstrom) -> bond order via tuned thresholds
    (reference: bond_analyze.py:101-126)."""
    distance = 100.0 * distance  # to pm
    if check_exists:
        if atom1 not in BONDS1 or atom2 not in BONDS1[atom1]:
            return 0
    if distance < BONDS1[atom1][atom2] + MARGIN1:
        if atom1 in BONDS2 and atom2 in BONDS2[atom1]:
            if distance < BONDS2[atom1][atom2] + MARGIN2:
                if atom1 in BONDS3 and atom2 in BONDS3[atom1]:
                    if distance < BONDS3[atom1][atom2] + MARGIN3:
                        return 3
                return 2
        return 1
    return 0


def geom_predictor(pair: Tuple[str, str], distance: float,
                   limit_bonds_to_one: bool = False) -> int:
    """GEOM-Drugs variant (reference: bond_analyze.py:135-144)."""
    order = get_bond_order(pair[0], pair[1], distance, check_exists=True)
    if limit_bonds_to_one:
        return 1 if order > 0 else 0
    return order


def build_bond_graph(positions: np.ndarray, atom_types: Sequence[int],
                     atom_decoder: Sequence[str],
                     dataset: str = "qm9") -> np.ndarray:
    """Pairwise bond orders [N, N] from coordinates."""
    n = len(atom_types)
    orders = np.zeros((n, n), np.int32)
    for i in range(n):
        for j in range(i + 1, n):
            dist = float(np.linalg.norm(positions[i] - positions[j]))
            a_i, a_j = atom_decoder[atom_types[i]], atom_decoder[atom_types[j]]
            if dataset == "geom":
                pair = sorted([atom_types[i], atom_types[j]])
                order = geom_predictor(
                    (atom_decoder[pair[0]], atom_decoder[pair[1]]), dist)
            else:
                order = get_bond_order(a_i, a_j, dist)
            orders[i, j] = orders[j, i] = order
    return orders


def _connected(orders: np.ndarray) -> bool:
    n = orders.shape[0]
    if n == 0:
        return False
    seen = {0}
    frontier = [0]
    adj = orders > 0
    while frontier:
        i = frontier.pop()
        for j in np.flatnonzero(adj[i]):
            if j not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == n


def _mol_from_graph(positions, atom_types, orders, atom_decoder):
    """Build an RDKit mol from the predicted bond graph
    (reference: rdkit_functions.build_molecule)."""
    mol = Chem.RWMol()
    for t in atom_types:
        mol.AddAtom(Chem.Atom(atom_decoder[t]))
    btype = {1: Chem.BondType.SINGLE, 2: Chem.BondType.DOUBLE,
             3: Chem.BondType.TRIPLE}
    n = len(atom_types)
    for i in range(n):
        for j in range(i + 1, n):
            if orders[i, j] > 0:
                mol.AddBond(i, j, btype[int(orders[i, j])])
    return mol


def _n_stable_atoms(orders: np.ndarray, atom_types: Sequence[int],
                    atom_decoder: Sequence[str]) -> int:
    """Atoms whose bond count is an allowed valence (qm9/analyze.py:20-56)."""
    n_stable = 0
    for t, nb in zip(atom_types, orders.sum(axis=1)):
        allowed = ALLOWED_BONDS[atom_decoder[t]]
        n_stable += int((nb == allowed) if isinstance(allowed, int) else (nb in allowed))
    return n_stable


def check_stability(positions: np.ndarray, atom_types: Sequence[int],
                    atom_decoder: Sequence[str] = QM9_ATOM_DECODER,
                    dataset: str = "qm9") -> Tuple[bool, int, int]:
    """(molecule_stable, n_stable_atoms, n_atoms) over the bonds inferred
    from distances (reference: qm9/analyze.py:20-56)."""
    orders = build_bond_graph(positions, atom_types, atom_decoder, dataset)
    n_stable = _n_stable_atoms(orders, atom_types, atom_decoder)
    return n_stable == len(atom_types), n_stable, len(atom_types)


def _graph_key(orders: np.ndarray, atom_types: Sequence[int]) -> str:
    """A canonical-ish hash of the bond graph, for rdkit-free uniqueness."""
    n = len(atom_types)
    deg = orders.sum(1)
    rows = sorted(
        (int(atom_types[i]), int(deg[i]),
         tuple(sorted((int(atom_types[j]), int(orders[i, j]))
                      for j in range(n) if orders[i, j] > 0)))
        for i in range(n))
    return str(rows)


@dataclass
class MoleculeMetrics:
    """Stability, validity, uniqueness (and novelty against train_smiles)
    over a list of (positions [N,3], atom_types [N]) molecules, the bonds
    inferred from distances (EDM's metric). Without rdkit a molecule is
    valid when it is connected and every atom is stable, and uniqueness
    hashes the bond graph."""

    atom_decoder: Sequence[str] = tuple(QM9_ATOM_DECODER)
    dataset: str = "qm9"
    train_smiles: Optional[set] = None

    def evaluate(self, molecules: List[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, float]:
        n_mols = len(molecules)
        mol_stable = atoms_stable = atoms_total = 0
        valid_keys = []
        for positions, atom_types in molecules:
            orders = build_bond_graph(positions, atom_types, self.atom_decoder, self.dataset)
            stable_atoms = _n_stable_atoms(orders, atom_types, self.atom_decoder)
            mol_stable += int(stable_atoms == len(atom_types))
            atoms_stable += stable_atoms
            atoms_total += len(atom_types)
            if HAVE_RDKIT:
                try:
                    mol = _mol_from_graph(positions, atom_types, orders, self.atom_decoder)
                    Chem.SanitizeMol(mol)
                    if len(Chem.GetMolFrags(mol)) == 1:
                        valid_keys.append(Chem.MolToSmiles(mol))
                except Exception:  # any rdkit failure makes the molecule invalid
                    pass
            elif _connected(orders) and stable_atoms == len(atom_types):
                valid_keys.append(_graph_key(orders, atom_types))

        n_valid = len(valid_keys)
        unique = set(valid_keys)
        metrics = {
            "mol_stable": mol_stable / max(1, n_mols),
            "atom_stable": atoms_stable / max(1, atoms_total),
            "validity": n_valid / max(1, n_mols),
            "uniqueness": len(unique) / max(1, n_valid),
            "relaxed_validity": compute_relaxed_validity(molecules, self.atom_decoder,
                                                         self.dataset),
            # which validity semantics produced the numbers
            "rdkit": HAVE_RDKIT,
        }
        metrics["pb_valid"] = posebusters_checks(molecules, self.atom_decoder,
                                                 self.dataset)["pb_valid"]
        if self.train_smiles is not None:
            novel = [k for k in unique if k not in self.train_smiles]
            metrics["novelty"] = len(novel) / max(1, len(unique))
        return metrics


# ---------------------------------------------------------------------------
# SemlaFlow-style GRAPH metrics: the model co-generates bond categories, so
# stability/validity/uniqueness are computed over the PREDICTED bond graph —
# NOT re-inferred from coordinate distances (that is the EDM metric above).
# Reference: semlaflow/flowmodels/fm.py:276-306 (atom_stabilities: predicted
# adjacency, aromatic counts 1.5, charge-aware valences),
# semlaflow/util/metrics.py:12-60 (ALLOWED_VALENCIES) + :162-198
# (Validity = RDKit sanitize on the built mol, fc-validity additionally
# requires connectivity; Uniqueness = canonical smiles over valid mols),
# semlaflow/util/rdkit.py:63-79 (bond order 4 = aromatic; charge index map).
# ---------------------------------------------------------------------------

SEMLA_ALLOWED_VALENCIES = {
    "H": {0: 1, 1: 0, -1: 0},
    "C": {0: [3, 4], 1: 3, -1: 3},
    "N": {0: [2, 3], 1: [2, 3, 4], -1: 2},
    "O": {0: 2, 1: 3, -1: 1},
    "F": {0: 1, -1: 0},
    "B": 3, "Al": 3, "Si": 4,
    "P": {0: [3, 5], 1: 4},
    "S": {0: [2, 6], 1: [2, 3], 2: 4, 3: 5, -1: 3},
    "Cl": 1, "As": 3,
    "Br": {0: 1, 1: 2},
    "I": 1, "Hg": [1, 2], "Bi": [3, 5],
}

# charge-head category index -> formal charge (semlaflow/util/rdkit.py:71-79)
SEMLA_IDX_CHARGES = (0, 1, 2, 3, -1, -2, -3)


def _is_valid_valence(valence: float, allowed, charge: int) -> bool:
    if isinstance(allowed, int):
        return allowed == valence
    if isinstance(allowed, (list, tuple)):
        return valence in allowed
    if isinstance(allowed, dict):
        entry = allowed.get(charge)
        if entry is None:
            return False
        return _is_valid_valence(valence, entry, charge)
    return False


def graph_valences(orders: np.ndarray) -> np.ndarray:
    """Integer valences from a predicted bond-order matrix: aromatic (4)
    counts 1.5, then truncate (reference: fm.py:287-290
    `adj[adj == 4] = 1.5; adj.sum(-1).long()`). Self-bonds (the diagonal)
    are excluded, matching the reference's lower-triangle bond extraction
    (util/functional bonds_from_adj, lower_tri=True) and
    _mol_from_graph_charged, which only adds i<j bonds."""
    o = np.asarray(orders, np.float64).copy()
    o[np.asarray(orders) == 4] = 1.5
    n = o.shape[-1]
    o[..., np.arange(n), np.arange(n)] = 0.0
    return o.sum(-1).astype(np.int64)


def check_graph_stability(atom_types: Sequence[int], orders: np.ndarray,
                          charges: Optional[Sequence[int]] = None,
                          atom_decoder: Sequence[str] = QM9_ATOM_DECODER,
                          ) -> Tuple[bool, int, int]:
    """(molecule_stable, n_stable_atoms, n_atoms) over the PREDICTED bond
    graph with charge-aware allowed valences (fm.py:276-306)."""
    n = len(atom_types)
    if charges is None:
        charges = [0] * n
    valences = graph_valences(orders)
    n_stable = 0
    for t, v, c in zip(atom_types, valences, charges):
        sym = atom_decoder[int(t)]
        allowed = SEMLA_ALLOWED_VALENCIES.get(sym)
        if allowed is None:
            continue
        n_stable += int(_is_valid_valence(int(v), allowed, int(c)))
    return n_stable == n, n_stable, n


def _mol_from_graph_charged(positions, atom_types, orders, charges,
                            atom_decoder):
    """RDKit mol from a predicted graph with aromatic bonds + formal charges
    (reference: semlaflow/util/rdkit.py mol_from_atoms)."""
    mol = Chem.RWMol()
    for t, c in zip(atom_types, charges):
        a = Chem.Atom(atom_decoder[int(t)])
        a.SetFormalCharge(int(c))
        mol.AddAtom(a)
    btype = {1: Chem.BondType.SINGLE, 2: Chem.BondType.DOUBLE,
             3: Chem.BondType.TRIPLE, 4: Chem.BondType.AROMATIC}
    n = len(atom_types)
    for i in range(n):
        for j in range(i + 1, n):
            if orders[i, j] > 0:
                mol.AddBond(i, j, btype[int(orders[i, j])])
    conf = Chem.Conformer(n)
    for i in range(n):
        conf.SetAtomPosition(i, [float(x) for x in positions[i]])
    mol.AddConformer(conf)
    return mol


def _charged_graph_key(orders: np.ndarray, atom_types: Sequence[int],
                       charges: Sequence[int]) -> str:
    """RDKit-free uniqueness key over (types, charges, bond multiset)."""
    n = len(atom_types)
    deg = graph_valences(orders)
    rows = sorted(
        (int(atom_types[i]), int(charges[i]), int(deg[i]),
         tuple(sorted((int(atom_types[j]), int(orders[i, j]))
                      for j in range(n) if orders[i, j] > 0)))
        for i in range(n))
    return str(rows)


@dataclass
class GraphMoleculeMetrics:
    """SemlaFlow metric collection over PREDICTED molecule graphs: each
    molecule is (positions [N,3], atom_types [N], bond_orders [N,N] int,
    formal_charges [N] int or None). Reports stability (charge-aware
    valences, aromatic=1.5), validity (RDKit sanitize; rdkit-free fallback =
    every valence valid), fc_validity (additionally connected), uniqueness
    (canonical smiles / graph hash over valid molecules), and the geometry
    audit pb_valid over distance-inferred bonds (coordinates must still be
    plausible even though validity is graph-based)."""

    atom_decoder: Sequence[str] = tuple(QM9_ATOM_DECODER)
    dataset: str = "qm9"
    train_keys: Optional[set] = None

    def evaluate(self, molecules) -> Dict[str, float]:
        n_mols = len(molecules)
        mol_stable = 0
        atoms_stable = 0
        atoms_total = 0
        valid_keys = []
        fc_valid = 0
        for positions, atom_types, orders, charges in molecules:
            if charges is None:
                charges = np.zeros(len(atom_types), np.int64)
            stable, n_stable, n = check_graph_stability(
                atom_types, orders, charges, self.atom_decoder)
            mol_stable += int(stable)
            atoms_stable += n_stable
            atoms_total += n
            connected = _connected(np.asarray(orders))

            if HAVE_RDKIT:
                try:
                    mol = _mol_from_graph_charged(
                        positions, atom_types, orders, charges,
                        self.atom_decoder)
                    Chem.SanitizeMol(mol)
                    valid_keys.append(Chem.MolToSmiles(mol))
                    fc_valid += int(connected)
                except Exception:
                    pass
            else:
                # rdkit-free proxy for sanitize: every atom at an allowed
                # (charge-aware) valence
                if stable:
                    valid_keys.append(_charged_graph_key(
                        np.asarray(orders), atom_types, charges))
                    fc_valid += int(connected)

        n_valid = len(valid_keys)
        unique = set(valid_keys)
        metrics = {
            "mol_stable": mol_stable / max(1, n_mols),
            "atom_stable": atoms_stable / max(1, atoms_total),
            "validity": n_valid / max(1, n_mols),
            "fc_validity": fc_valid / max(1, n_mols),
            "uniqueness": len(unique) / max(1, n_valid),
            # self-describing: True = RDKit sanitize/canonical-SMILES
            # semantics, False = valence-stability / graph-hash fallback
            "rdkit": HAVE_RDKIT,
        }
        coords_mols = [(p, t) for p, t, _, _ in molecules]
        metrics["pb_valid"] = posebusters_checks(
            coords_mols, self.atom_decoder, self.dataset)["pb_valid"]
        if self.train_keys is not None:
            novel = [k for k in unique if k not in self.train_keys]
            metrics["novelty"] = len(novel) / max(1, len(unique))
        return metrics


def _largest_fragment(orders: np.ndarray) -> np.ndarray:
    """Indices of the largest connected component of the bond graph."""
    n = orders.shape[0]
    unseen = set(range(n))
    best: List[int] = []
    adj = orders > 0
    while unseen:
        root = unseen.pop()
        comp = [root]
        stack = [root]
        while stack:
            i = stack.pop()
            for j in np.flatnonzero(adj[i]):
                j = int(j)
                if j in unseen:
                    unseen.discard(j)
                    comp.append(j)
                    stack.append(j)
        if len(comp) > len(best):
            best = comp
    return np.array(sorted(best), np.int64)


def compute_relaxed_validity(molecules, atom_decoder=QM9_ATOM_DECODER,
                             dataset: str = "qm9") -> float:
    """Validity on the LARGEST fragment with formal charges allowed
    (reference: rdkit_functions.py:271-286 compute_relaxed_validity +
    build_molecule_with_partial_charges). With RDKit the exact reference
    path runs; without it, valences may fall anywhere in the element's
    charged-valence range."""
    if not molecules:
        return 0.0
    n_valid = 0
    for positions, atom_types in molecules:
        orders = build_bond_graph(positions, atom_types, atom_decoder,
                                  dataset)
        if HAVE_RDKIT:
            try:
                mol = _mol_from_graph(positions, atom_types, orders,
                                      atom_decoder)
                frags = Chem.rdmolops.GetMolFrags(mol, asMols=True,
                                                  sanitizeFrags=False)
                largest = max(frags, default=mol,
                              key=lambda m: m.GetNumAtoms())
                Chem.SanitizeMol(largest)
                n_valid += 1
            except Exception:
                pass
            continue
        frag = _largest_fragment(orders)
        if len(frag) < 1:
            continue
        sub = orders[np.ix_(frag, frag)]
        ok = True
        for local_i, i in enumerate(frag):
            lo, hi = CHARGED_VALENCES[atom_decoder[int(atom_types[i])]]
            nb = sub[local_i].sum()
            if not (lo <= nb <= hi):
                ok = False
                break
        n_valid += int(ok)
    return n_valid / len(molecules)


def posebusters_checks(molecules, atom_decoder=QM9_ATOM_DECODER,
                       dataset: str = "qm9",
                       length_tol: Tuple[float, float] = (0.75, 1.25),
                       min_angle_deg: float = 50.0,
                       clash_ratio: float = 0.8) -> Dict[str, float]:
    """Geometry-plausibility audit with PoseBusters' 'mol' pass criteria
    (reference: rdkit_functions.py:345-380 runs the external PoseBusters
    package; this is a native implementation of the same checks):
    all_atoms_connected, bond lengths within [0.75, 1.25]x the reference
    single/double/triple length, bond angles above a sanity floor, and no
    internal steric clash (non-bonded 1-4+ pairs closer than 0.8x the
    covalent-radius sum). When the posebusters package is importable the
    external tool is used instead."""
    try:  # pragma: no cover - package not in this image
        import posebusters  # noqa: F401

        have_pb = True
    except ImportError:
        have_pb = False
    del have_pb  # external path would go through PoseBusters(config="mol")

    table = {1: BONDS1, 2: BONDS2, 3: BONDS3}
    results = {"all_atoms_connected": 0, "bond_lengths": 0,
               "bond_angles": 0, "internal_steric_clash": 0, "pb_valid": 0}
    for positions, atom_types in molecules:
        pos = np.asarray(positions, np.float64)
        orders = build_bond_graph(pos, atom_types, atom_decoder, dataset)
        n = len(atom_types)
        syms = [atom_decoder[int(t)] for t in atom_types]
        connected = _connected(orders)

        lengths_ok = True
        for i in range(n):
            for j in range(i + 1, n):
                o = int(orders[i, j])
                if o == 0:
                    continue
                ref = table[o].get(syms[i], {}).get(syms[j])
                if ref is None:
                    ref = table[o].get(syms[j], {}).get(syms[i])
                if ref is None:
                    continue
                d = np.linalg.norm(pos[i] - pos[j]) * 100.0  # pm
                if not (length_tol[0] * ref <= d <= length_tol[1] * ref):
                    lengths_ok = False

        angles_ok = True
        adj = orders > 0
        for j in range(n):
            nbrs = np.flatnonzero(adj[j])
            for a in range(len(nbrs)):
                for b in range(a + 1, len(nbrs)):
                    v1 = pos[nbrs[a]] - pos[j]
                    v2 = pos[nbrs[b]] - pos[j]
                    cosang = np.dot(v1, v2) / (np.linalg.norm(v1)
                                               * np.linalg.norm(v2) + 1e-12)
                    if np.degrees(np.arccos(np.clip(cosang, -1, 1))) \
                            < min_angle_deg:
                        angles_ok = False

        # 1-2 and 1-3 pairs are bonded geometry; everything else must keep
        # clash_ratio x covalent distance
        bonded2 = (adj | (adj.astype(int) @ adj.astype(int) > 0))
        clash_ok = True
        for i in range(n):
            for j in range(i + 1, n):
                if bonded2[i, j]:
                    continue
                d = np.linalg.norm(pos[i] - pos[j])
                if d < clash_ratio * (COVALENT_RADII[syms[i]]
                                      + COVALENT_RADII[syms[j]]):
                    clash_ok = False

        results["all_atoms_connected"] += int(connected)
        results["bond_lengths"] += int(lengths_ok)
        results["bond_angles"] += int(angles_ok)
        results["internal_steric_clash"] += int(clash_ok)
        results["pb_valid"] += int(connected and lengths_ok and angles_ok
                                   and clash_ok)
    m = max(1, len(molecules))
    return {k: v / m for k, v in results.items()}


def mmff_energies(smiles_or_mols, per_atom: bool = False):
    """MMFF94 energies via RDKit (EnergyValidity / AverageEnergy analogs,
    reference: semlaflow/util/metrics.py:216-402). Requires rdkit."""
    if not HAVE_RDKIT:
        raise RuntimeError("rdkit is not available in this environment")
    from rdkit.Chem import AllChem  # pragma: no cover - not in this image

    energies = []
    for m in smiles_or_mols:
        mol = Chem.MolFromSmiles(m) if isinstance(m, str) else m
        if mol is None:
            energies.append(float("nan"))
            continue
        try:
            props = AllChem.MMFFGetMoleculeProperties(mol)
            ff = AllChem.MMFFGetMoleculeForceField(mol, props)
            e = ff.CalcEnergy()
            energies.append(e / mol.GetNumAtoms() if per_atom else e)
        except Exception:  # rdkit raises bare exceptions on unparametrised molecules
            energies.append(float("nan"))
    return energies


class DistributionNodes:
    """Histogram sampler over molecule sizes (reference: qm9/models.py
    DistributionNodes)."""

    def __init__(self, histogram: Dict[int, float]):
        self.sizes = np.array(sorted(histogram), np.int64)
        probs = np.array([histogram[s] for s in self.sizes], np.float64)
        self.probs = probs / probs.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(self.sizes, size=n, p=self.probs)

    def log_prob(self, sizes: np.ndarray) -> np.ndarray:
        idx = np.clip(np.searchsorted(self.sizes, sizes), 0, len(self.sizes) - 1)
        return np.log(np.where(self.sizes[idx] == sizes, self.probs[idx], 1e-30))


class DistributionProperty:
    """Conditional property sampler binned by molecule size (reference:
    qm9/models.py DistributionProperty): a target is drawn uniformly from
    the values of the training molecules of the same size, or of the
    nearest size present."""

    def __init__(self, sizes: np.ndarray, values: np.ndarray, num_bins: int = 1000):
        del num_bins  # the reference's histogram bins; the pools are exact
        self.by_size: Dict[int, np.ndarray] = {}
        sizes = np.asarray(sizes)
        values = np.asarray(values, np.float64)
        for s in np.unique(sizes):
            self.by_size[int(s)] = values[sizes == s]

    def sample(self, rng: np.random.Generator, sizes: np.ndarray) -> np.ndarray:
        out = np.zeros(len(sizes))
        for i, s in enumerate(np.asarray(sizes)):
            pool = self.by_size.get(int(s))
            if pool is None or len(pool) == 0:
                nearest = min(self.by_size, key=lambda k: abs(k - int(s)))
                pool = self.by_size[nearest]
            out[i] = rng.choice(pool)
        return out
