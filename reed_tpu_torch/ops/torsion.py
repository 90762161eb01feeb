"""Torsion / internal-coordinate utilities on molecular graphs, the
port's copy of reed_tpu/ops/torsion.py (host-side numpy).

The numpy counterpart of molecule/torsion_utils.py (get_torsions,
Get/SetDihedral, Get/SetBondLength, Get/SetAngle, add_equi_noise) working
directly on the port's `data.molecule.GeometricMol` records instead of
RDKit conformers: ring perception by cycle-edge detection, rotatable-bond
enumeration (non-ring single bonds between non-terminal atoms), dihedral
measurement/rotation of the bond-split subtree, and the GeoRCG-style
equivariant noise that perturbs bond lengths, bond angles, and torsions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from reed_tpu_torch.data.molecule import GeometricMol


def _adjacency(mol) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in range(mol.seq_length)]
    for (i, j) in mol.bond_indices:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    return adj


def _connected_without(adj, n, a, b) -> bool:
    """Is a reachable from b when edge (a, b) is removed?"""
    seen = {b}
    stack = [b]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if u == b and v == a:
                continue
            if v == a:
                return True
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return False


def ring_bonds(mol) -> set:
    """Bonds on a cycle: removing them keeps the endpoints connected."""
    adj = _adjacency(mol)
    out = set()
    for (i, j) in mol.bond_indices:
        i, j = int(i), int(j)
        if _connected_without(adj, mol.seq_length, i, j):
            out.add((min(i, j), max(i, j)))
    return out


def ring_atoms(mol) -> set:
    return {a for bond in ring_bonds(mol) for a in bond}


def bond_side(mol, j: int, k: int) -> np.ndarray:
    """Atom indices on k's side when bond (j, k) is cut (k included)."""
    adj = _adjacency(mol)
    seen = {j, k}
    stack = [k]
    side = [k]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if u == k and v == j:
                continue
            if v not in seen:
                seen.add(v)
                stack.append(v)
                side.append(v)
    return np.array(sorted(side), np.int64)


def get_rotatable_bonds(mol) -> List[Tuple[int, int]]:
    """Non-ring single bonds whose endpoints both have degree >= 2 and are
    not in a triple bond — the '[!$(*#*)&!D1]-&!@[...]' SMARTS the
    reference matches (torsion_utils.py:15)."""
    adj = _adjacency(mol)
    rings = ring_bonds(mol)
    triple_atoms = set()
    for (i, j), t in zip(mol.bond_indices, mol.bond_types):
        if int(t) == 3:
            triple_atoms.update((int(i), int(j)))
    out = []
    for (i, j), t in zip(mol.bond_indices, mol.bond_types):
        i, j = int(i), int(j)
        if int(t) != 1 or (min(i, j), max(i, j)) in rings:
            continue
        if len(adj[i]) < 2 or len(adj[j]) < 2:
            continue
        if i in triple_atoms or j in triple_atoms:
            continue
        out.append((i, j))
    return out


def get_torsions(mols: Sequence) -> List[Tuple[int, int, int, int]]:
    """One (i, j, k, l) dihedral per rotatable bond (j, k); ring neighbors
    are preferred for the outer atoms like the reference
    (torsion_utils.py:10-52). Indices offset per molecule."""
    out = []
    offset = 0
    for mol in mols:
        adj = _adjacency(mol)
        rings = ring_atoms(mol)
        for (j, k) in get_rotatable_bonds(mol):
            i_candidates = [n for n in adj[j] if n != k]
            l_candidates = [n for n in adj[k] if n != j]
            if not i_candidates or not l_candidates:
                continue
            i = i_candidates[0]
            ls = [n for n in l_candidates if n != i]
            if not ls:
                continue
            l = ls[0]
            if l in rings:
                out.append((l + offset, k + offset, j + offset, i + offset))
            else:
                out.append((i + offset, j + offset, k + offset, l + offset))
        offset += mol.seq_length
    return out


def get_dihedral(coords, idx) -> float:
    """Signed dihedral angle (degrees) of atoms idx=(i, j, k, l)."""
    p = np.asarray(coords, np.float64)[list(idx)]
    b1, b2, b3 = p[1] - p[0], p[2] - p[1], p[3] - p[2]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    m = np.cross(n1, b2 / (np.linalg.norm(b2) + 1e-12))
    x = np.dot(n1, n2)
    y = np.dot(m, n2)
    return float(np.degrees(np.arctan2(y, x)))


def _rotate_about_axis(points, origin, axis, angle_rad):
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    p = points - origin
    cos, sin = np.cos(angle_rad), np.sin(angle_rad)
    return (p * cos + np.cross(axis, p) * sin
            + axis * np.dot(p, axis)[:, None] * (1 - cos)) + origin


def set_dihedral(mol, idx, value_deg: float) -> GeometricMol:
    """Rotate the l-side subtree about the j-k axis so dihedral(i,j,k,l)
    becomes value_deg (rdMolTransforms.SetDihedralDeg semantics)."""
    i, j, k, l = idx
    coords = np.array(mol.coords, np.float64)
    # rotating the l-side by +delta about j->k DECREASES the signed
    # dihedral under the arctan2 convention above, hence the minus
    delta = -np.radians(value_deg - get_dihedral(coords, idx))
    side = bond_side(mol, j, k)
    coords[side] = _rotate_about_axis(coords[side], coords[k],
                                      coords[k] - coords[j], delta)
    return GeometricMol(coords.astype(np.float32), mol.atomics,
                        mol.bond_indices, mol.bond_types, mol.charges,
                        mol.str_id)


def get_bond_length(coords, idx) -> float:
    p = np.asarray(coords, np.float64)
    return float(np.linalg.norm(p[idx[0]] - p[idx[1]]))


def set_bond_length(mol, idx, value: float) -> GeometricMol:
    """Translate the j-side subtree along the bond axis."""
    i, j = idx
    coords = np.array(mol.coords, np.float64)
    axis = coords[j] - coords[i]
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    delta = value - get_bond_length(coords, idx)
    side = bond_side(mol, i, j)
    coords[side] += axis * delta
    return GeometricMol(coords.astype(np.float32), mol.atomics,
                        mol.bond_indices, mol.bond_types, mol.charges,
                        mol.str_id)


def get_angle(coords, idx) -> float:
    """Bond angle (degrees) at j for atoms idx=(i, j, k)."""
    p = np.asarray(coords, np.float64)
    v1 = p[idx[0]] - p[idx[1]]
    v2 = p[idx[2]] - p[idx[1]]
    cosang = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2)
                               + 1e-12)
    return float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))


def set_angle(mol, idx, value_deg: float) -> GeometricMol:
    """Rotate the k-side subtree in the i-j-k plane about j."""
    i, j, k = idx
    coords = np.array(mol.coords, np.float64)
    axis = np.cross(coords[i] - coords[j], coords[k] - coords[j])
    if np.linalg.norm(axis) < 1e-9:  # collinear: any perpendicular axis
        v = coords[i] - coords[j]
        axis = np.cross(v, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(v, np.array([0.0, 1.0, 0.0]))
    delta = np.radians(value_deg - get_angle(coords, idx))
    side = bond_side(mol, j, k)
    coords[side] = _rotate_about_axis(coords[side], coords[j], axis, delta)
    return GeometricMol(coords.astype(np.float32), mol.atomics,
                        mol.bond_indices, mol.bond_types, mol.charges,
                        mol.str_id)


def add_equi_noise(mol, rng: np.random.Generator, bond_var: float = 0.04,
                   angle_var: float = 0.04, torsion_var: float = 2.0
                   ) -> Tuple[GeometricMol, Dict[str, List]]:
    """GeoRCG equivariant geometry noise (torsion_utils.py:199-334):
    gaussian perturbation of non-ring bond lengths, bond angles at
    degree>=2 centers, and rotatable-bond torsions. Returns the noised
    molecule and the per-internal-coordinate deltas."""
    rings = ring_atoms(mol)
    ring_b = ring_bonds(mol)
    adj = _adjacency(mol)
    labels: Dict[str, List] = {"bond": [], "angle": [], "torsion": []}

    for (i, j) in mol.bond_indices:
        i, j = int(i), int(j)
        if (min(i, j), max(i, j)) in ring_b:
            continue
        old = get_bond_length(mol.coords, (i, j))
        new = rng.normal(old, bond_var)
        mol = set_bond_length(mol, (i, j), new)
        labels["bond"].append([i, j, new - old])

    for j in range(mol.seq_length):
        if len(adj[j]) < 2:
            continue
        nbrs = list(adj[j])
        ring_nbrs = [n for n in nbrs if n in rings]
        i = ring_nbrs[0] if (j in rings and ring_nbrs) else nbrs[0]
        for k in nbrs:
            if k == i:
                continue
            if i in rings and j in rings and k in rings:
                continue
            old = get_angle(mol.coords, (i, j, k))
            new = rng.normal(old, angle_var)
            mol = set_angle(mol, (i, j, k), new)
            labels["angle"].append([i, j, k, new - old])

    for torsion in get_torsions([mol]):
        old = get_dihedral(mol.coords, torsion)
        new = rng.normal(old, torsion_var)
        mol = set_dihedral(mol, torsion, new)
        labels["torsion"].append([*torsion, new - old])
    return mol, labels
