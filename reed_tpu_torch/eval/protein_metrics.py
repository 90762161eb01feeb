"""Protein evaluation: sequence recovery, backbone RMSD (Kabsch), PDB and
mmCIF backbone readers, a PDB backbone writer, backbone geometry stats and
a folding-model subprocess harness.

Counterparts of reed_tpu/eval/protein_metrics.py's numpy functions
(reference: protein/fmif/train_fmif.py:464-540 recovery accounting,
protein/multiflow/models/folding_model.py:14-166 for the folding
interface, gated on an external command being present).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

from reed_tpu_torch.data.protein import ALPHABET_WITH_MASK


def sequence_recovery(pred_tokens, true_tokens, mask) -> float:
    """Fraction of correctly recovered residues over valid positions."""
    pred = np.asarray(pred_tokens)
    true = np.asarray(true_tokens)
    m = np.asarray(mask).astype(bool)
    return float((pred[m] == true[m]).mean())


def tokens_to_sequence(tokens, mask=None) -> str:
    tokens = np.asarray(tokens)
    if mask is not None:
        tokens = tokens[np.asarray(mask).astype(bool)]
    return "".join(ALPHABET_WITH_MASK[t] for t in tokens)


def kabsch_rmsd(p: np.ndarray, q: np.ndarray) -> float:
    """Optimal-superposition RMSD between two [N, 3] coordinate sets."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    p = p - p.mean(0)
    q = q - q.mean(0)
    u, _, vt = np.linalg.svd(p.T @ q)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    diff = p @ rot.T - q
    return float(np.sqrt((diff ** 2).sum(-1).mean()))


def backbone_rmsd(x_pred: np.ndarray, x_true: np.ndarray,
                  mask: np.ndarray) -> float:
    """bb-RMSD over all four backbone atoms of valid residues."""
    m = np.asarray(mask).astype(bool)
    p = np.asarray(x_pred)[m].reshape(-1, 3)
    q = np.asarray(x_true)[m].reshape(-1, 3)
    return kabsch_rmsd(p, q)


class FoldingModel:
    """Host-side folding-evaluation harness.

    Mirrors the reference FoldingModel contract
    (protein/multiflow/models/folding_model.py): fold sequences to
    structures + pLDDT via an external tool, run as
    `command + [fasta, output_dir]` (e.g. a colabfold or ESMFold CLI
    wrapper). `available` is False without a command or when its program
    is not on PATH, and fold_fasta then raises.
    """

    def __init__(self, command: Optional[List[str]] = None):
        # e.g. ["colabfold_batch", "--num-models", "1"] or an esmfold CLI
        self.command = command
        self._checked = None

    @property
    def available(self) -> bool:
        if self.command is None:
            return False
        if self._checked is None:
            self._checked = shutil.which(self.command[0]) is not None
        return self._checked

    def fold_fasta(self, sequences: Dict[str, str], output_dir: str) -> Dict:
        """Write fasta, run the folding tool, return paths + pLDDTs parsed
        from output PDB B-factors (reference: folding_model.py:35-73)."""
        if not self.available:
            raise RuntimeError(
                "no folding backend configured; set FoldingModel(command=...)")
        os.makedirs(output_dir, exist_ok=True)
        fasta = os.path.join(output_dir, "input.fasta")
        with open(fasta, "w") as f:
            for name, seq in sequences.items():
                f.write(f">{name}\n{seq}\n")
        subprocess.run(self.command + [fasta, output_dir], check=True)
        results = {}
        for name in sequences:
            pdb_path = self._find_pdb(output_dir, name)
            results[name] = {
                "pdb": pdb_path,
                "plddt": self._mean_plddt(pdb_path) if pdb_path else None,
            }
        return results

    @staticmethod
    def _find_pdb(output_dir: str, name: str) -> Optional[str]:
        for fn in sorted(os.listdir(output_dir)):
            if fn.startswith(name) and fn.endswith(".pdb"):
                return os.path.join(output_dir, fn)
        return None

    @staticmethod
    def _mean_plddt(pdb_path: str) -> float:
        """Mean of CA B-factor column (pLDDT convention)."""
        vals = []
        with open(pdb_path) as f:
            for line in f:
                if line.startswith("ATOM") and line[12:16].strip() == "CA":
                    vals.append(float(line[60:66]))
        return float(np.mean(vals)) if vals else float("nan")


def parse_pdb_backbone(pdb_path: str) -> np.ndarray:
    """Read N/CA/C/O coords from a PDB file -> [L, 4, 3]."""
    atoms = {"N": 0, "CA": 1, "C": 2, "O": 3}
    residues: Dict[int, np.ndarray] = {}
    with open(pdb_path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            name = line[12:16].strip()
            if name not in atoms:
                continue
            resi = int(line[22:26])
            xyz = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
            residues.setdefault(resi, np.full((4, 3), np.nan))[
                atoms[name]] = xyz
    keys = sorted(residues)
    return np.stack([residues[k] for k in keys])


def parse_mmcif_backbone(cif_path: str, chain: Optional[str] = None):
    """Minimal mmCIF parser: read the _atom_site loop and return
    (backbone coords [L, 4, 3] for N/CA/C/O, sequence string).

    Replaces the reference's vendored OpenFold mmcif parsing
    (protein/multiflow/data/mmcif_parsing.py) for the backbone-only use the
    pipelines need."""
    atoms = {"N": 0, "CA": 1, "C": 2, "O": 3}
    aa3to1 = {v: k for k, v in {
        "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE",
        "G": "GLY", "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU",
        "M": "MET", "N": "ASN", "P": "PRO", "Q": "GLN", "R": "ARG",
        "S": "SER", "T": "THR", "V": "VAL", "W": "TRP", "Y": "TYR",
    }.items()}

    header: List[str] = []
    residues: Dict[tuple, np.ndarray] = {}
    resnames: Dict[tuple, str] = {}
    in_loop = False
    with open(cif_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("_atom_site."):
                header.append(line.split(".")[1].strip())
                in_loop = True
                continue
            if in_loop:
                if line.startswith(("#", "loop_", "_")):
                    if header and line.startswith("_") \
                            and not line.startswith("_atom_site."):
                        in_loop = False
                    if line.startswith(("#", "loop_")):
                        in_loop = bool(header) and False
                    continue
                parts = line.split()
                if len(parts) < len(header):
                    continue
                row = dict(zip(header, parts))
                if row.get("group_PDB") not in ("ATOM",):
                    continue
                if chain and row.get("auth_asym_id",
                                     row.get("label_asym_id")) != chain:
                    continue
                name = row.get("label_atom_id", "").strip('"')
                if name not in atoms:
                    continue
                try:
                    seq_id = int(row.get("label_seq_id"))
                except (TypeError, ValueError):
                    continue
                key = (row.get("label_asym_id", "A"), seq_id)
                residues.setdefault(key, np.full((4, 3), np.nan))[
                    atoms[name]] = [float(row["Cartn_x"]),
                                    float(row["Cartn_y"]),
                                    float(row["Cartn_z"])]
                resnames[key] = row.get("label_comp_id", "UNK")
    keys = sorted(residues)
    coords = np.stack([residues[k] for k in keys]) if keys else \
        np.zeros((0, 4, 3))
    seq = "".join(aa3to1.get(resnames[k], "X") for k in keys)
    return coords, seq


def write_pdb_backbone(path: str, atom37: np.ndarray,
                       aatypes: Optional[np.ndarray] = None,
                       res_mask: Optional[np.ndarray] = None,
                       chain: str = "A"):
    """Write backbone atoms (atom37 order: N, CA, C, CB, O) of one chain to
    a PDB file — the sampling-output path the reference gets from
    multiflow/data/protein.py to_pdb (clean-room minimal writer)."""
    from reed_tpu_torch.ops.residue_constants import RESTYPE_1TO3, RESTYPES

    atom_names = ["N", "CA", "C", "CB", "O"]
    elements = ["N", "C", "C", "C", "O"]
    a37 = np.asarray(atom37)
    n_res = a37.shape[0]
    mask = (np.asarray(res_mask) if res_mask is not None
            else np.ones(n_res))
    lines = []
    serial = 1
    for r in range(n_res):
        if mask[r] <= 0:
            continue
        res3 = "ALA"
        if aatypes is not None and 0 <= int(aatypes[r]) < 20:
            res3 = RESTYPE_1TO3[RESTYPES[int(aatypes[r])]]
        for a, (name, elem) in enumerate(zip(atom_names, elements)):
            if res3 == "GLY" and name == "CB":
                continue
            x, y, z = a37[r, a]
            lines.append(
                f"ATOM  {serial:5d}  {name:<3s}{res3} {chain}{r + 1:4d}"
                f"    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                f"          {elem:>2s}")
            serial += 1
    lines.append("TER")
    lines.append("END")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def backbone_geometry_report(atom37: np.ndarray,
                             res_mask: Optional[np.ndarray] = None
                             ) -> Dict[str, float]:
    """Sanity stats over a sampled backbone: CA-CA distances (ideal 3.8 A),
    radius of gyration, CA clash fraction (reference gates these through
    folding designability, which needs external binaries)."""
    a37 = np.asarray(atom37)
    mask = (np.asarray(res_mask).astype(bool) if res_mask is not None
            else np.ones(a37.shape[0], bool))
    ca = a37[mask, 1]
    if len(ca) < 2:
        return {"ca_ca_dist_mean": float("nan")}
    d = np.linalg.norm(np.diff(ca, axis=0), axis=-1)
    com = ca.mean(0)
    rg = float(np.sqrt(((ca - com) ** 2).sum(-1).mean()))
    pair = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
    iu = np.triu_indices(len(ca), 2)  # non-adjacent pairs
    clash = float((pair[iu] < 3.0).mean()) if len(iu[0]) else 0.0
    return {"ca_ca_dist_mean": float(d.mean()),
            "ca_ca_dist_std": float(d.std()),
            "radius_of_gyration": rg,
            "ca_clash_fraction": clash}
