"""Protein data pipelines. Counterpart of reed_tpu/data/protein.py (numpy;
the reference's per-chain .pt files are read with torch.load).

The inverse-folding (fmif) half: PDB cluster splits, chain loading with
AF3 embeddings, and fixed-bucket token-budget batching; lengths snap to a
fixed bucket ladder, as in reed_tpu, so batches come in a few fixed
shapes. The MultiFlow half: .pdb/.cif chains -> backbone rigids, aatypes
in AF2 order, and shuffled epochs of MultiflowTrainer batches, cropped or
padded to max_len, with the batch-OT translation prior coupled here on
the host where asked (reference: multiflow/data/pdb_dataloader.py,
datasets.py).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# the token alphabet of the whole fmif path (model, sampler, metrics)
ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
ALPHABET_WITH_MASK = ALPHABET + "Z"
TOKEN_INDEX = {c: i for i, c in enumerate(ALPHABET_WITH_MASK)}
MASK_TOKEN_INDEX = TOKEN_INDEX["Z"]  # 21
NUM_TOKENS = len(ALPHABET_WITH_MASK)  # 22

DEFAULT_BUCKETS = (64, 128, 192, 256)


@dataclass
class PDBParams:
    data_dir: str                     # contains pdb/<mid>/<pdbid>*.pt
    list_csv: str = "list.csv"
    val_ids: str = "valid_clusters.txt"
    test_ids: str = "test_clusters.txt"
    repr_dir: Optional[str] = None    # AF3 embeddings per cluster
    rescut: float = 3.5
    datcut: str = "2030-01-01"
    max_len: int = 10_000


def build_training_clusters(params: PDBParams, debug: bool = False):
    """list.csv -> {cluster_id: [(chain_id, hash), ...]} for the train,
    valid and test splits."""
    from datetime import date

    def parse_date(s):
        return date.fromisoformat(s[:10])

    with open(os.path.join(params.data_dir, params.val_ids)) as f:
        val_ids = set(int(line) for line in f)
    with open(os.path.join(params.data_dir, params.test_ids)) as f:
        test_ids = set(int(line) for line in f)
    if debug:
        val_ids, test_ids = set(), set()

    datcut = parse_date(params.datcut)
    with open(os.path.join(params.data_dir, params.list_csv)) as f:
        reader = csv.reader(f)
        next(reader)
        rows = [[r[0], r[3], int(r[4])] for r in reader
                if float(r[2]) <= params.rescut
                and parse_date(r[1]) <= datcut
                and len(r[-1]) <= params.max_len]
    if debug:
        rows = rows[:20]

    train, valid, test = {}, {}, {}
    for chain_id, h, cluster in rows:
        target = (valid if cluster in val_ids
                  else test if cluster in test_ids else train)
        target.setdefault(cluster, []).append((chain_id, h))
    if debug:
        valid = test = train
    return train, valid, test


def load_chain(params: PDBParams, chain_id: str, cluster_id) -> Optional[Dict]:
    """One chain's backbone (N, Ca, C, O) and sequence, with its AF3
    embeddings when params.repr_dir is set; numpy. The .pt files are
    unpickled, so read only datasets you trust."""
    import torch

    pdbid, chid = chain_id.split("_")
    prefix = os.path.join(params.data_dir, "pdb", pdbid[1:3], pdbid)
    if not os.path.isfile(prefix + ".pt"):
        return None
    chain = torch.load(f"{prefix}_{chid}.pt", map_location="cpu",
                       weights_only=False)
    seq = chain["seq"]
    n = len(seq)
    out = {
        "seq": seq,
        "xyz": np.asarray(chain["xyz"], np.float32)[:, :4],
        "name": chain_id,
    }
    if params.repr_dir is not None:
        reprs = np.load(os.path.join(
            params.repr_dir, f"cluster_{cluster_id}",
            "seed-0_embeddings", "embeddings.npz"))
        out["repr_single"] = reprs["single_embeddings"][:n].astype(np.float32)
        out["repr_pair"] = reprs["pair_embeddings"][:n, :n].astype(np.float32)
        out["repr_structure"] = reprs["structure_embeddings"][:n].astype(
            np.float32)
    return out


def sample_cluster_chains(rng: np.random.Generator, clusters: Dict,
                          params: PDBParams, max_length: int = 256,
                          limit: Optional[int] = None) -> List[Dict]:
    """One epoch's structures: the first chain of each cluster (in a shuffled
    cluster order), kept if its sequence is in the alphabet and no longer
    than max_length."""
    alphabet_set = set(ALPHABET)
    out = []
    ids = list(clusters)
    rng.shuffle(ids)
    for cid in ids:
        chain_id, _ = clusters[cid][0]
        entry = load_chain(params, chain_id, cid)
        if entry is None or not isinstance(entry["seq"], str):
            continue
        if set(entry["seq"]) - alphabet_set:
            continue
        if len(entry["seq"]) > max_length:
            continue
        out.append(entry)
        if limit is not None and len(out) >= limit:
            break
    return out


def bucket_for_length(length: int,
                      buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


# byte -> token lookup table (vectorises the per-character lookups)
_SEQ_LUT = np.full(256, TOKEN_INDEX["X"], np.int32)
for _c, _i in TOKEN_INDEX.items():
    _SEQ_LUT[ord(_c)] = _i


class BufferPool:
    """Reusable featurize output buffers, `depth` sets per shape, so that
    batches after the first `depth` write into memory that is already
    paged in. Arrays featurize returns from a pool are overwritten `depth`
    calls later: `depth` must exceed the batches a consumer holds at once."""

    def __init__(self, depth: int = 3):
        self.depth = depth
        self._sets: Dict[tuple, List[Dict[str, np.ndarray]]] = {}
        self._next: Dict[tuple, int] = {}

    def buffers(self, key: tuple, spec: Dict[str, tuple]):
        sets = self._sets.setdefault(key, [])
        if len(sets) < self.depth:
            sets.append({name: np.empty(shape, dtype)
                         for name, (shape, dtype) in spec.items()})
            self._next[key] = len(sets) % self.depth
            return sets[-1]
        i = self._next[key]
        self._next[key] = (i + 1) % self.depth
        return sets[i]


def featurize(entries: List[Dict], bucket_len: int,
              repr_dims: Optional[Dict[str, int]] = None,
              pool: Optional[BufferPool] = None) -> Dict[str, np.ndarray]:
    """Pad chains to [B, bucket_len, ...] arrays of the model's batch schema
    (X, S, mask, chain_M, residue_idx, chain_encoding_all, and the AF3
    embeddings with repr_dims). Pad positions: zero coordinates, token X,
    mask 0, residue index -100."""
    b = len(entries)
    l = bucket_len
    spec = {
        "X": ((b, l, 4, 3), np.float32),
        "S": ((b, l), np.int32),
        "mask": ((b, l), np.float32),
        "chain_M": ((b, l), np.float32),
        "residue_idx": ((b, l), np.int32),
        "chain_encoding_all": ((b, l), np.int32),
    }
    if repr_dims:
        spec["repr_single"] = ((b, l, repr_dims["single"]), np.float32)
        spec["repr_pair"] = ((b, l, l, repr_dims["pair"]), np.float32)
        spec["repr_structure"] = ((b, l, repr_dims["structure"]), np.float32)
    if pool is not None:
        batch = pool.buffers(("featurize", b, l, bool(repr_dims),
                              tuple(sorted((repr_dims or {}).items()))), spec)
    else:
        batch = {name: np.empty(shape, dtype)
                 for name, (shape, dtype) in spec.items()}
    x, s, mask = batch["X"], batch["S"], batch["mask"]
    residue_idx = batch["residue_idx"]
    batch["chain_M"][:] = 1.0
    batch["chain_encoding_all"][:] = 0
    for i, e in enumerate(entries):
        n = min(len(e["seq"]), l)
        xyz_raw = np.asarray(e["xyz"], np.float32)[:n]
        x[i, :n] = np.nan_to_num(xyz_raw)
        x[i, n:] = 0.0
        codes = np.frombuffer(e["seq"][:n].encode("latin-1"), np.uint8)
        s[i, :n] = _SEQ_LUT[codes]
        s[i, n:] = TOKEN_INDEX["X"]
        mask[i, :n] = np.isfinite(xyz_raw).all((1, 2)).astype(np.float32)
        mask[i, n:] = 0.0
        residue_idx[i, :n] = np.arange(n)
        residue_idx[i, n:] = -100
        if repr_dims:
            for key in ("repr_single", "repr_structure"):
                batch[key][i, :n] = e[key][:n] if key in e else 0.0
                batch[key][i, n:] = 0.0
            pair = batch["repr_pair"]
            pair[i, :n, :n] = e["repr_pair"][:n, :n] if "repr_pair" in e else 0.0
            pair[i, :n, n:] = 0.0
            pair[i, n:, :] = 0.0
    return dict(batch)


def token_bucket_batches(entries: List[Dict], token_budget: int = 20_000,
                         buckets: Sequence[int] = DEFAULT_BUCKETS,
                         repr_dims: Optional[Dict[str, int]] = None,
                         shuffle_rng: Optional[np.random.Generator] = None,
                         pool: Optional[BufferPool] = None,
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches: chains grouped by padded length, batch size
    token_budget // bucket_len, the last batch of a bucket filled up with
    repeats."""
    by_bucket: Dict[int, List[Dict]] = {}
    for e in entries:
        by_bucket.setdefault(bucket_for_length(len(e["seq"]), buckets),
                             []).append(e)
    batches = []
    for bucket_len, items in by_bucket.items():
        bs = max(1, token_budget // bucket_len)
        for i in range(0, len(items), bs):
            chunk = items[i:i + bs]
            while len(chunk) < bs:  # pad the batch with repeats
                chunk = chunk + chunk[: bs - len(chunk)]
            batches.append((bucket_len, chunk))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(batches)
    for bucket_len, chunk in batches:
        yield featurize(chunk, bucket_len, repr_dims, pool=pool)


def synthetic_entries(rng: np.random.Generator, n: int = 16,
                      min_len: int = 20, max_len: int = 256,
                      repr_dims: Optional[Dict[str, int]] = None
                      ) -> List[Dict]:
    """Random chains with the loader schema (for tests and smoke runs)."""
    out = []
    for _ in range(n):
        length = int(rng.integers(min_len, max_len + 1))
        seq = "".join(rng.choice(list(ALPHABET[:20]), size=length))
        steps = rng.standard_normal((length, 3)).astype(np.float32) * 1.5
        ca = np.cumsum(steps, 0) + np.arange(length)[:, None] * [3.8, 0, 0]
        offsets = np.array([[-1.46, 0, 0], [0, 0, 0], [1.52, 0, 0],
                            [2.4, 1.0, 0]], np.float32)
        entry = {"seq": seq, "xyz": ca[:, None, :] + offsets[None],
                 "name": f"synth_{length}"}
        if repr_dims:
            entry["repr_single"] = rng.standard_normal(
                (length, repr_dims["single"])).astype(np.float32)
            entry["repr_pair"] = rng.standard_normal(
                (length, length, repr_dims["pair"])).astype(np.float32)
            entry["repr_structure"] = rng.standard_normal(
                (length, repr_dims["structure"])).astype(np.float32)
        out.append(entry)
    return out


# -- MultiFlow SE(3) codesign data (reference: multiflow/data/pdb_dataloader.py,
#    datasets.py) -------------------------------------------------------------

# AF2 canonical residue-type order (reference:
# protein/multiflow/data/residue_constants.py restypes)
AF2_RESTYPES = "ARNDCQEGHILKMFPSTWYV"
AF2_RESTYPE_ORDER = {c: i for i, c in enumerate(AF2_RESTYPES)}
AA3TO1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}


def rigids_from_backbone(bb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Backbone atoms [L, >=3, 3] (N, CA, C order) -> residue frames.

    Gram-Schmidt construction of the AF2 backbone rigid group
    (reference: multiflow/data/all_atom.py / openfold rigids_from_3_points):
    e1 along CA->C, e2 the orthogonalized CA->N direction, origin at CA.
    Returns (rotmats [L,3,3], trans [L,3])."""
    n, ca, c = bb[:, 0], bb[:, 1], bb[:, 2]
    v1 = c - ca
    v2 = n - ca
    e1 = v1 / (np.linalg.norm(v1, axis=-1, keepdims=True) + 1e-8)
    u2 = v2 - (e1 * v2).sum(-1, keepdims=True) * e1
    e2 = u2 / (np.linalg.norm(u2, axis=-1, keepdims=True) + 1e-8)
    e3 = np.cross(e1, e2)
    rotmats = np.stack([e1, e2, e3], axis=-1)  # columns = frame axes
    return rotmats.astype(np.float32), ca.astype(np.float32)


def parse_backbone_any(path: str) -> Tuple[np.ndarray, str]:
    """PDB or mmCIF file -> (backbone [L,4,3] N/CA/C/O, sequence str)."""
    if path.endswith((".cif", ".cif.gz")):
        from reed_tpu_torch.eval.protein_metrics import parse_mmcif_backbone

        return parse_mmcif_backbone(path)
    atoms = {"N": 0, "CA": 1, "C": 2, "O": 3}
    residues: Dict[int, np.ndarray] = {}
    resnames: Dict[int, str] = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            name = line[12:16].strip()
            if name not in atoms:
                continue
            resi = int(line[22:26])
            residues.setdefault(resi, np.full((4, 3), np.nan))[atoms[name]] \
                = [float(line[30:38]), float(line[38:46]), float(line[46:54])]
            resnames[resi] = line[17:20].strip()
    keys = sorted(residues)
    coords = (np.stack([residues[k] for k in keys]) if keys
              else np.zeros((0, 4, 3)))
    seq = "".join(AA3TO1.get(resnames[k], "X") for k in keys)
    return coords, seq


def load_multiflow_entries(data_dir: str,
                           max_entries: Optional[int] = None) -> List[Dict]:
    """Scan a directory of .pdb/.cif files into multiflow records:
    {trans [L,3], rotmats [L,3,3], aatypes [L], name}. Residues with any
    missing N/CA/C atom are dropped; translations are zero-centered
    (reference: multiflow/data/datasets.py PdbDataset._process_csv_row)."""
    entries = []
    fnames = sorted(
        f for f in os.listdir(data_dir)
        if f.endswith((".pdb", ".cif")))
    for fname in fnames:
        bb, seq = parse_backbone_any(os.path.join(data_dir, fname))
        if len(bb) == 0:
            continue
        ok = ~np.isnan(bb[:, :3]).any(axis=(1, 2))
        bb, seq = bb[ok], "".join(s for s, m in zip(seq, ok) if m)
        if len(bb) < 4:
            continue
        rotmats, trans = rigids_from_backbone(bb)
        trans = trans - trans.mean(0, keepdims=True)
        aatypes = np.array([AF2_RESTYPE_ORDER.get(s, 0) for s in seq],
                           np.int32)
        entries.append({"trans": trans, "rotmats": rotmats,
                        "aatypes": aatypes, "name": fname})
        if max_entries is not None and len(entries) >= max_entries:
            break
    return entries


def multiflow_epoch_batches(data_dir: str, batch_size: int,
                            rng: np.random.Generator, max_len: int = 128,
                            entries: Optional[List[Dict]] = None,
                            trans_batch_ot: bool = False,
                            trans_scale: float = 10.0,
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """One shuffled epoch of MultiflowTrainer-schema batches. Chains longer
    than max_len are randomly cropped (contiguous window); shorter ones are
    zero-padded with res_mask (reference: pdb_dataloader.py length batching).
    With trans_batch_ot the coupled translation prior is computed here in
    the input pipeline (reference couples on-device per batch,
    multiflow/data/interpolant.py:88-107)."""
    if entries is None:
        entries = load_multiflow_entries(data_dir)
    if not entries:
        raise FileNotFoundError(f"no .pdb/.cif chains found in {data_dir}")
    order = rng.permutation(len(entries))
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if len(idx) < batch_size:  # pad-repeat to keep shapes static
            idx = np.concatenate([idx, order[:batch_size - len(idx)]])
        n = max_len
        trans = np.zeros((batch_size, n, 3), np.float32)
        rotmats = np.tile(np.eye(3, dtype=np.float32),
                          (batch_size, n, 1, 1))
        aatypes = np.zeros((batch_size, n), np.int32)
        res_mask = np.zeros((batch_size, n), np.float32)
        res_idx = np.tile(np.arange(n, dtype=np.int32), (batch_size, 1))
        for j, e_i in enumerate(idx):
            e = entries[e_i]
            l = len(e["aatypes"])
            if l > n:
                start = int(rng.integers(0, l - n + 1))
                sl = slice(start, start + n)
                l = n
            else:
                sl = slice(0, l)
            t = e["trans"][sl]
            trans[j, :l] = t - t.mean(0, keepdims=True)
            rotmats[j, :l] = e["rotmats"][sl]
            aatypes[j, :l] = e["aatypes"][sl]
            res_mask[j, :l] = 1.0
        batch = {"trans_1": trans, "rotmats_1": rotmats,
                 "aatypes_1": aatypes, "res_mask": res_mask,
                 "res_idx": res_idx}
        if trans_batch_ot:
            from reed_tpu_torch.diffusion.se3 import batch_ot_trans_prior

            batch["trans_0"] = batch_ot_trans_prior(rng, trans, res_mask,
                                                    trans_scale)
        yield batch
