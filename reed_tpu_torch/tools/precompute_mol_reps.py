"""Precompute frozen-encoder molecule reps: a `.rsmol` dataset -> reps.npy.

The port's counterpart of tools/precompute_mol_reps.py. The reference runs
the frozen UniMol or Frad encoder on every training batch
(molecule/semlaflow/train.py:300-330); here the reps are computed once, in
batches on the device, and the trainers read reps.npy beside the dataset
(`--data-dir`, reed_tpu_torch/cli.py `_load_reps`), with sizes.npy (atoms a
molecule) beside it.

Weights: the converted npz that reed_tpu's tool takes (reed_tpu's flax tree
flattened to 'a/b/c' keys, read with encoders/flax_tree.load_npz), or a
reference torch checkpoint (UniMol's state dict, or Frad's TorchMD-ET under
'representation_model.'), told apart by the file's suffix.

  python -m reed_tpu_torch.tools.precompute_mol_reps --data geom/train.rsmol.npz \\
      --weights unimol_global.npz --encoder unimol [--out geom/reps.npy]
  python -m reed_tpu_torch.tools.precompute_mol_reps --data qm9/train.rsmol.npz \\
      --weights frad_qm9.ckpt --encoder frad --batch-size 128
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from reed_tpu_torch import resolve_device, synchronize

# atomic numbers of the default 18-token vocabulary (PAD, MASK, then atoms)
VOCAB_ATOMIC_NUMBERS = {
    "H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16, "Cl": 17,
    "Br": 35, "B": 5, "Al": 13, "Si": 14, "As": 33, "I": 53, "Hg": 80,
    "Bi": 83,
}


def load_encoder(kind: str, weights: str, device):
    """The UniMolGlobal or FradEncoder holding `weights` (a reed_tpu npz or a
    reference torch checkpoint), on `device`, in eval mode."""
    from reed_tpu_torch.encoders import torchmd_et, unimol_convert
    from reed_tpu_torch.encoders.flax_tree import load_npz

    npz = weights.endswith(".npz")
    if kind == "unimol":
        sd = (unimol_convert.state_dict_from_flax(load_npz(weights)) if npz
              else unimol_convert.load_torch_unimol_checkpoint(weights))
        return unimol_convert.unimol_from_state_dict(sd, device=device)
    if kind == "frad":
        sd = (torchmd_et.state_dict_from_flax(load_npz(weights)) if npz
              else torchmd_et.load_torchmd_et_checkpoint(weights))
        return torchmd_et.frad_from_state_dict(sd, device=device)
    raise ValueError(f"encoder must be unimol or frad, got {kind!r}")


def _dense(chunk, max_n):
    b = len(chunk)
    atomics = np.zeros((b, max_n), np.int64)
    coords = np.zeros((b, max_n, 3), np.float32)
    mask = np.zeros((b, max_n), np.float32)
    for j, m in enumerate(chunk):
        n = m.seq_length
        atomics[j, :n] = m.atomics
        coords[j, :n] = m.coords
        mask[j, :n] = 1.0
    return atomics, coords, mask


def unimol_inputs(chunk, max_n):
    """UniMol's (tokens, distances, edge types) of a list of molecules, padded
    to max_n atoms (+ BOS/EOS): the vocabulary ids less the PAD/MASK offset."""
    from reed_tpu_torch.encoders.unimol import format_input_to_unimol

    atomics, coords, mask = _dense(chunk, max_n)
    types = np.where(mask > 0, atomics - 2, 0)
    return format_input_to_unimol(types, coords, mask)


def frad_inputs(chunk, max_n, vocab_tokens):
    """Frad's (atomic numbers, positions, mask) of a list of molecules."""
    atomics, coords, mask = _dense(chunk, max_n)
    z = np.zeros_like(atomics)
    for j, m in enumerate(chunk):
        z[j, :m.seq_length] = [VOCAB_ATOMIC_NUMBERS.get(vocab_tokens[int(t)], 6)
                               for t in m.atomics]
    return z, coords, mask


@torch.no_grad()
def encode(model, kind: str, mols, batch_size: int, device, vocab_tokens=None,
           log_every: int = 0):
    """Reps [len(mols), R] f32 in dataset order, batch_size molecules a
    device call, every batch padded to the dataset's largest molecule."""
    max_n = max(m.seq_length for m in mols)
    out = []
    for i in range(0, len(mols), batch_size):
        chunk = mols[i:i + batch_size]
        arrays = (unimol_inputs(chunk, max_n) if kind == "unimol"
                  else frad_inputs(chunk, max_n, vocab_tokens))
        out.append(model(*(torch.from_numpy(np.asarray(a)).to(device) for a in arrays))
                   .float().cpu().numpy())
        if log_every and (i // batch_size) % log_every == 0:
            print(f"{i + len(chunk)}/{len(mols)}", flush=True)
    return np.concatenate(out)


def main(argv=None):
    ap = argparse.ArgumentParser("precompute_mol_reps")
    ap.add_argument("--data", required=True, help=".rsmol dataset (.rsmol.npz)")
    ap.add_argument("--weights", required=True,
                    help="reed_tpu's converted npz, or a reference torch checkpoint")
    ap.add_argument("--encoder", choices=["unimol", "frad"], default="unimol")
    ap.add_argument("--out", default=None, help="default: reps.npy beside --data")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from reed_tpu_torch.data.molecule import build_vocab, load_dataset

    device = resolve_device(args.device)
    mols = load_dataset(args.data)
    model = load_encoder(args.encoder, args.weights, device)
    print(f"{len(mols)} molecules, encoder={args.encoder}, device={device}")
    t0 = time.perf_counter()
    reps = encode(model, args.encoder, mols, args.batch_size, device,
                  vocab_tokens=build_vocab().tokens, log_every=50)
    synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"encoded {len(mols)} molecules in {seconds:.3f} s: {len(mols) / seconds:.1f} "
          f"molecules/s (batch {args.batch_size}, host batching and copies included)")
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.data)), "reps.npy")
    np.save(out, reps)
    np.save(os.path.join(os.path.dirname(os.path.abspath(out)), "sizes.npy"),
            np.array([m.seq_length for m in mols], np.int64))
    print(f"wrote {out} {reps.shape} + sizes.npy")
    return reps


if __name__ == "__main__":
    main()
