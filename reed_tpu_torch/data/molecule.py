"""Molecule data layer, the port's copy of the SemlaFlow half of
reed_tpu/data/molecule.py (host-side numpy): the atom vocabulary, the
GeometricMol record, the `.rsmol` dataset container (one npz of ragged
arrays; reed_tpu reads the files this writes and the other way round),
coordinate normalisation, size-bucketed dense collation and the
SemlaTrainer epoch iterator (prior, OT coupling and interpolation per
batch, as the reference's collate does); and the EDM half: the QM9 EDM
npz loader and the MoleculeEDMTrainer epoch iterator (dense collation of
positions, one-hot types and charges with the node and edge masks); and
`build_geom_dataset`, the GEOM-Drugs msgpack to `.rsmol` builder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

# reference: semlaflow/scriptutil.py:22-23
QM9_COORDS_STD_DEV = 1.723299503326416
GEOM_COORDS_STD_DEV = 2.407038688659668

PAD_TOKEN, MASK_TOKEN = "<PAD>", "<MASK>"
CORE_ATOMS = ["H", "C", "N", "O", "F", "P", "S", "Cl"]
OTHER_ATOMS = ["Br", "B", "Al", "Si", "As", "I", "Hg", "Bi"]


class Vocabulary:
    """Atom-type vocabulary; PAD fixed at index 0
    (reference: scriptutil.py:109-115)."""

    def __init__(self, tokens: Optional[Sequence[str]] = None):
        self.tokens = list(tokens) if tokens is not None else (
            [PAD_TOKEN, MASK_TOKEN] + CORE_ATOMS + OTHER_ATOMS)
        self.index = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self):
        return len(self.tokens)

    def encode(self, symbols: Sequence[str]) -> np.ndarray:
        return np.array([self.index[s] for s in symbols], np.int32)

    def decode(self, ids) -> List[str]:
        return [self.tokens[int(i)] for i in ids]

    @property
    def mask_index(self) -> int:
        return self.index[MASK_TOKEN]


def build_vocab() -> Vocabulary:
    return Vocabulary()


@dataclass
class GeometricMol:
    """One molecule: coords [N,3], atom-type ids [N], sparse bonds
    [M,3] (i, j, type), charges [N] (reference: molrepr.py:273-585)."""

    coords: np.ndarray
    atomics: np.ndarray
    bond_indices: np.ndarray          # [M, 2]
    bond_types: np.ndarray            # [M]
    charges: Optional[np.ndarray] = None
    str_id: Optional[str] = None      # canonical smiles when available

    @property
    def seq_length(self) -> int:
        return len(self.atomics)

    def zero_com(self) -> "GeometricMol":
        coords = self.coords - self.coords.mean(0, keepdims=True)
        return GeometricMol(coords, self.atomics, self.bond_indices,
                            self.bond_types, self.charges, self.str_id)

    def rotate(self, rot: np.ndarray) -> "GeometricMol":
        return GeometricMol(self.coords @ rot.T, self.atomics,
                            self.bond_indices, self.bond_types,
                            self.charges, self.str_id)

    def permute(self, perm: Sequence[int]) -> "GeometricMol":
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        bonds = self.bond_indices.copy()
        if len(bonds):
            bonds = inv[bonds]
        charges = None if self.charges is None else self.charges[perm]
        return GeometricMol(self.coords[perm], self.atomics[perm], bonds,
                            self.bond_types.copy(), charges, self.str_id)

    def dense_bonds(self, n_bond_types: int) -> np.ndarray:
        n = self.seq_length
        adj = np.zeros((n, n), np.int64)
        for (i, j), t in zip(self.bond_indices, self.bond_types):
            adj[i, j] = adj[j, i] = t
        return np.eye(n_bond_types, dtype=np.float32)[adj]


def save_dataset(path: str, mols: List[GeometricMol]):
    """Serialize a list of molecules into one npz container (`.rsmol`)."""
    lengths = np.array([m.seq_length for m in mols], np.int32)
    n_bonds = np.array([len(m.bond_indices) for m in mols], np.int32)
    payload = {
        "lengths": lengths,
        "n_bonds": n_bonds,
        "coords": np.concatenate([m.coords.astype(np.float32)
                                  for m in mols]),
        "atomics": np.concatenate([m.atomics.astype(np.int32)
                                   for m in mols]),
        "bond_indices": (np.concatenate(
            [m.bond_indices.reshape(-1, 2).astype(np.int32) for m in mols])
            if n_bonds.sum() else np.zeros((0, 2), np.int32)),
        "bond_types": (np.concatenate(
            [m.bond_types.astype(np.int32) for m in mols])
            if n_bonds.sum() else np.zeros((0,), np.int32)),
        "charges": np.concatenate(
            [(m.charges if m.charges is not None
              else np.zeros(m.seq_length)).astype(np.int32) for m in mols]),
        "smiles": np.array([m.str_id or "" for m in mols]),
    }
    np.savez_compressed(path, **payload)


def load_dataset(path: str) -> List[GeometricMol]:
    z = np.load(path, allow_pickle=False)
    lengths, n_bonds = z["lengths"], z["n_bonds"]
    mols = []
    co = ao = bo = 0
    for l, nb, smi in zip(lengths, n_bonds, z["smiles"]):
        mols.append(GeometricMol(
            coords=z["coords"][co:co + l],
            atomics=z["atomics"][ao:ao + l],
            bond_indices=z["bond_indices"][bo:bo + nb],
            bond_types=z["bond_types"][bo:bo + nb],
            charges=z["charges"][ao:ao + l],
            str_id=str(smi) or None))
        co += l
        ao += l
        bo += nb
    return mols


def mol_transform(mol: GeometricMol, coord_std: float) -> GeometricMol:
    """Zero CoM + scale coords by the dataset std
    (reference: scriptutil.py:74-90)."""
    m = mol.zero_com()
    return GeometricMol(m.coords / coord_std, m.atomics, m.bond_indices,
                        m.bond_types, m.charges, m.str_id)


# -- bucketed batching (reference: datamodules.py:118-146) -------------------

DEFAULT_BUCKET_LIMITS = (24, 32, 48, 64, 96, 128, 192, 256)


def bucket_batches(mols: List[GeometricMol], batch_cost: int = 4096,
                   bucket_limits: Sequence[int] = DEFAULT_BUCKET_LIMITS,
                   n_bond_types: int = 5, n_charge_types: int = 7,
                   vocab_size: int = 18,
                   shuffle_rng: Optional[np.random.Generator] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape dense batches: bucket by padded size, batch size =
    batch_cost // bucket."""
    by_bucket: Dict[int, List[GeometricMol]] = {}
    for m in mols:
        for b in bucket_limits:
            if m.seq_length <= b:
                by_bucket.setdefault(b, []).append(m)
                break
    batches = []
    for bucket, items in by_bucket.items():
        bs = max(1, batch_cost // bucket)
        for i in range(0, len(items), bs):
            chunk = items[i:i + bs]
            while len(chunk) < bs:
                chunk = chunk + chunk[: bs - len(chunk)]
            batches.append((bucket, chunk))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(batches)
    for bucket, chunk in batches:
        yield collate_dense(chunk, bucket, vocab_size, n_bond_types,
                            n_charge_types)


def collate_dense(mols: List[GeometricMol], max_n: int, vocab_size: int,
                  n_bond_types: int, n_charge_types: int
                  ) -> Dict[str, np.ndarray]:
    b = len(mols)
    coords = np.zeros((b, max_n, 3), np.float32)
    atomics = np.zeros((b, max_n, vocab_size), np.float32)
    bonds = np.zeros((b, max_n, max_n, n_bond_types), np.float32)
    charges = np.zeros((b, max_n, n_charge_types), np.float32)
    mask = np.zeros((b, max_n), np.float32)
    bonds[:, :, :, 0] = 1.0  # default: no-bond class
    for i, m in enumerate(mols):
        n = m.seq_length
        coords[i, :n] = m.coords
        atomics[i, :n] = np.eye(vocab_size, dtype=np.float32)[m.atomics]
        bonds[i, :n, :n] = m.dense_bonds(n_bond_types)
        ch = (m.charges if m.charges is not None else np.zeros(n, np.int64))
        # charge encoding: offset by 2 so [-2..4] -> [0..6] (7 classes)
        ch_idx = np.clip(ch + 2, 0, n_charge_types - 1).astype(np.int64)
        charges[i, :n] = np.eye(n_charge_types, dtype=np.float32)[ch_idx]
        mask[i, :n] = 1.0
    return {"coords": coords, "atomics": atomics, "bonds": bonds,
            "charges": charges, "mask": mask}


# -- trainer-facing epoch iterators ------------------------------------------

def semla_epoch_batches(mols: List[GeometricMol], interpolant_cfg,
                        rng: np.random.Generator,
                        reps: Optional[np.ndarray] = None,
                        batch_cost: int = 4096,
                        bucket_limits: Sequence[int] = DEFAULT_BUCKET_LIMITS,
                        vocab_size: int = 18, n_bond_types: int = 5,
                        n_charge_types: int = 7
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """One shuffled epoch of SemlaTrainer-schema batches: size-bucketed dense
    collation + host-side prior/OT-coupled interpolation, exactly what the
    reference's datamodule collate does per batch
    (molecule/semlaflow/train.py:264-375, data/datamodules.py:242;
    interpolation-in-collate at data/interpolate.py). `reps` are precomputed
    frozen-encoder reps aligned with `mols` by index."""
    from reed_tpu_torch.diffusion.molecule_fm import interpolate_batch

    by_bucket: Dict[int, List[int]] = {}
    for idx, m in enumerate(mols):
        for b in bucket_limits:
            if m.seq_length <= b:
                by_bucket.setdefault(b, []).append(idx)
                break
    batches = []
    for bucket, idxs in by_bucket.items():
        arr = np.asarray(idxs)
        rng.shuffle(arr)
        bs = max(1, batch_cost // bucket)
        for i in range(0, len(arr), bs):
            chunk = arr[i:i + bs]
            if len(chunk) < bs:  # pad-repeat so each bucket compiles once
                chunk = np.concatenate([chunk, arr[:bs - len(chunk)]])
            batches.append((bucket, chunk))
    for bi in rng.permutation(len(batches)):
        bucket, chunk = batches[bi]
        data = collate_dense([mols[j] for j in chunk], bucket, vocab_size,
                             n_bond_types, n_charge_types)
        prior, interpolated, times = interpolate_batch(rng, interpolant_cfg,
                                                       data)
        batch = {"data": data, "prior": prior, "interpolated": interpolated,
                 "times": times}
        if reps is not None:
            batch["rep"] = reps[chunk]
        yield batch


# -- the EDM path (QM9 EDM npz) -----------------------------------------------

QM9_CHARGE_TO_TYPE = {1: 0, 6: 1, 7: 2, 8: 3, 9: 4}  # H, C, N, O, F
QM9_ATOM_DECODER = ["H", "C", "N", "O", "F"]


def edm_epoch_batches(data: Dict[str, np.ndarray], batch_size: int,
                      rng: np.random.Generator, reps: Optional[np.ndarray] = None,
                      max_nodes: int = 29, num_atom_types: int = 5,
                      include_charges: bool = True,
                      shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """One shuffled epoch of MoleculeEDMTrainer-schema batches (host numpy)
    from the EDM QM9 npz layout (positions / charges / num_atoms[, one_hot]),
    the dense collation of the reference's qm9/data/collate.py; types come
    from the atomic numbers where there is no one_hot. The last partial
    batch is dropped."""
    pos = np.asarray(data["positions"], np.float32)
    charges = np.asarray(data["charges"]) if "charges" in data else None
    one_hot_src = np.asarray(data["one_hot"]) if "one_hot" in data else None
    num_atoms = np.asarray(data["num_atoms"]).astype(np.int64)
    m, src_n = pos.shape[:2]
    n = max_nodes
    k = min(n, src_n)
    diag = np.eye(n, dtype=np.float32)[None, :, :, None]
    to_type = np.vectorize(lambda z: QM9_CHARGE_TO_TYPE.get(int(z), 0))

    order = rng.permutation(m) if shuffle else np.arange(m)
    for i in range(0, m - batch_size + 1, batch_size):
        idx = order[i:i + batch_size]
        node_mask = (np.arange(n)[None, :] < np.minimum(num_atoms[idx], n)[:, None]
                     ).astype(np.float32)[..., None]
        positions = np.zeros((batch_size, n, 3), np.float32)
        positions[:, :k] = pos[idx, :k]
        positions *= node_mask
        one_hot = np.zeros((batch_size, n, num_atom_types), np.float32)
        if one_hot_src is not None:
            one_hot[:, :k] = one_hot_src[idx, :k, :num_atom_types]
        else:
            one_hot[:, :k] = np.eye(num_atom_types, dtype=np.float32)[to_type(charges[idx, :k])]
        one_hot *= node_mask
        ch = np.zeros((batch_size, n, 1), np.float32)
        if charges is not None and include_charges:
            ch[:, :k, 0] = charges[idx, :k]
        ch *= node_mask
        edge_mask = node_mask[:, :, None, :] * node_mask[:, None, :, :] * (1.0 - diag)
        batch = {"positions": positions, "one_hot": one_hot, "charges": ch,
                 "node_mask": node_mask, "edge_mask": edge_mask}
        if reps is not None:
            batch["rep"] = reps[idx]
        yield batch


def load_qm9_edm_npz(path: str) -> Dict[str, np.ndarray]:
    """An EDM-format QM9 split npz (positions, charges, one_hot or atom
    types, num_atoms) as a dict of arrays; num_atoms is counted from the
    nonzero positions where the file has none."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    if "num_atoms" not in out and "positions" in out:
        out["num_atoms"] = (np.abs(out["positions"]).sum(-1) > 0).sum(-1)
    return out


# -- dataset builders ---------------------------------------------------------

def build_geom_dataset(msgpack_path: str, out_path: str,
                       vocab: Optional[Vocabulary] = None,
                       limit: Optional[int] = None):
    """GEOM-Drugs msgpack -> the lowest-energy conformer of each molecule,
    saved as a `.rsmol` dataset (reference:
    molecule/build_geom_dataset.py:11-120). Molecules with an element
    outside the vocabulary are skipped; returns the count written. Needs
    the msgpack package."""
    import msgpack

    vocab = vocab or build_vocab()
    mols: List[GeometricMol] = []
    with open(msgpack_path, "rb") as f:
        unpacker = msgpack.Unpacker(f)
        for batch in unpacker:
            for smiles, entry in batch.items():
                confs = entry.get("conformers", [])
                if not confs:
                    continue
                best = min(confs, key=lambda c: c.get("totalenergy", np.inf))
                xyz = np.array(best["xyz"], np.float32)  # [N, 4] (Z, x, y, z)
                symbols = [_PERIODIC.get(z, "C") for z in xyz[:, 0].astype(int)]
                try:
                    atomics = vocab.encode(symbols)
                except KeyError:
                    continue
                mols.append(GeometricMol(
                    coords=xyz[:, 1:], atomics=atomics,
                    bond_indices=np.zeros((0, 2), np.int32),
                    bond_types=np.zeros((0,), np.int32),
                    str_id=smiles if isinstance(smiles, str) else smiles.decode()))
                if limit is not None and len(mols) >= limit:
                    break
            if limit is not None and len(mols) >= limit:
                break
    save_dataset(out_path, mols)
    return len(mols)


_PERIODIC = {1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 13: "Al",
             14: "Si", 15: "P", 16: "S", 17: "Cl", 33: "As", 35: "Br",
             53: "I", 80: "Hg", 83: "Bi"}
