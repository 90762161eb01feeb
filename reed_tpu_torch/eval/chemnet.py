"""ChemNet (the FCD feature extractor) and the Frechet ChemNet Distance,
counterpart of reed_tpu/eval/chemnet.py.

The reference computes FCD through `fcd_torch` (molsets.py:6,529-580),
which runs a pretrained SMILES LSTM ("ChemNet") and takes the Frechet
distance over its 512-d penultimate activations. The pretrained weight
file is not in this repository, but the code is: the SMILES one-hot
encoding (the published FCD charset), a stacked-LSTM forward over
torch-layout weights (`weight_ih_l{k}` [4H, D], gate order (i, f, g, o),
so a ChemNet state dict converts without renaming) written as a plain
PyTorch step loop, f32 with TF32 off on the caller's device, and the FCD
statistic through eval/frechet.frechet_distance.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from reed_tpu_torch import resolve_device
from reed_tpu_torch.encoders.flax_tree import full_f32

# The published FCD SMILES charset (fcd / fcd_torch `get_one_hot`):
# multi-character tokens matched first, one UNK bucket, right-padded.
FCD_TOKENS = [
    "C", "N", "O", "H", "F", "Cl", "P", "B", "Br", "S", "I", "Si",
    "#", "(", ")", "+", "-", "1", "2", "3", "4", "5", "6", "7", "8",
    "=", "[", "]", "@", "c", "n", "o", "s", "X", ".",
]
UNK_INDEX = len(FCD_TOKENS)          # 35
VOCAB_SIZE = len(FCD_TOKENS) + 1     # 36 incl. UNK
MAX_LEN = 350

_TWO_CHAR = [t for t in FCD_TOKENS if len(t) == 2]


def tokenize_smiles(smiles: str) -> List[int]:
    """Greedy two-char-first tokenization (fcd one-hot convention)."""
    out: List[int] = []
    i = 0
    while i < len(smiles):
        two = smiles[i:i + 2]
        if two in _TWO_CHAR:
            out.append(FCD_TOKENS.index(two))
            i += 2
            continue
        ch = smiles[i]
        out.append(FCD_TOKENS.index(ch) if ch in FCD_TOKENS else UNK_INDEX)
        i += 1
    return out


def one_hot_smiles(smiles_list: Sequence[str], max_len: int = MAX_LEN) -> np.ndarray:
    """[B, max_len, VOCAB_SIZE] float32 one-hot, right-padded with zeros."""
    out = np.zeros((len(smiles_list), max_len, VOCAB_SIZE), np.float32)
    for b, smi in enumerate(smiles_list):
        for i, tok in enumerate(tokenize_smiles(smi)[:max_len]):
            out[b, i, tok] = 1.0
    return out


def lstm_forward(x, w_ih, w_hh, b_ih, b_hh):
    """One torch-layout LSTM layer over x [B,T,D]: weights [4H,D]/[4H,H],
    gate order (i, f, g, o). Returns the hidden states [B,T,H]."""
    h_dim = w_hh.shape[1]
    bias = (b_ih + b_hh)[None]
    x_proj = torch.nn.functional.linear(x, w_ih)   # [B,T,4H]
    h = x.new_zeros((x.shape[0], h_dim))
    c = x.new_zeros((x.shape[0], h_dim))
    hs = []
    for t in range(x.shape[1]):
        gates = x_proj[:, t] + h @ w_hh.T + bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


@full_f32
@torch.no_grad()
def chemnet_activations(params: Dict, one_hot) -> torch.Tensor:
    """The stacked LSTM and the penultimate Dense on one_hot [B,T,VOCAB]
    (numpy or a tensor; the weights move to its device): the last layer's
    final hidden state, through tanh(dense) where params has one.

    params: {"lstm": [{w_ih, w_hh, b_ih, b_hh}, ...],
             "dense": {kernel, bias} (optional penultimate projection)}
    """
    x = torch.as_tensor(one_hot, dtype=torch.float32)
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=x.device)  # noqa: E731
    for layer in params["lstm"]:
        x = lstm_forward(x, *(on(layer[k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")))
    # ChemNet reads the final hidden state of the last layer
    feats = x[:, -1]
    if "dense" in params:
        feats = torch.tanh(feats @ on(params["dense"]["kernel"]) + on(params["dense"]["bias"]))
    return feats


def convert_torch_chemnet(sd: Dict) -> Dict:
    """A torch state dict with nn.LSTM naming (lstm.weight_ih_l{k}, ...) and
    an optional `dense.weight/bias` penultimate layer -> params for
    chemnet_activations (f32 CPU tensors; the LSTM weights in torch layout
    as they are, the dense kernel transposed to [in, out])."""
    def _t(a):
        return torch.as_tensor(a).detach().float().cpu()

    layers = []
    k = 0
    while f"lstm.weight_ih_l{k}" in sd:
        layers.append({
            "w_ih": _t(sd[f"lstm.weight_ih_l{k}"]),
            "w_hh": _t(sd[f"lstm.weight_hh_l{k}"]),
            "b_ih": _t(sd[f"lstm.bias_ih_l{k}"]),
            "b_hh": _t(sd[f"lstm.bias_hh_l{k}"]),
        })
        k += 1
    if not layers:
        raise KeyError("no lstm.weight_ih_l0 in the state dict")
    params: Dict = {"lstm": layers}
    if "dense.weight" in sd:
        params["dense"] = {"kernel": _t(sd["dense.weight"]).T.contiguous(),
                           "bias": _t(sd["dense.bias"])}
    return params


def fcd_from_activations(act_gen: np.ndarray, act_ref: np.ndarray) -> float:
    from reed_tpu_torch.eval.frechet import frechet_distance

    return frechet_distance(act_gen.mean(0), np.cov(act_gen, rowvar=False),
                            act_ref.mean(0), np.cov(act_ref, rowvar=False))


def fcd_score(params: Dict, gen_smiles: Sequence[str], ref_smiles: Sequence[str],
              batch_size: int = 128, max_len: int = MAX_LEN, device=None) -> float:
    """FCD between two SMILES sets under a converted ChemNet, its forward on
    `device` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    on_device = {"lstm": [{k: v.to(device) for k, v in layer.items()}
                          for layer in params["lstm"]]}
    if "dense" in params:
        on_device["dense"] = {k: torch.as_tensor(v).to(device)
                              for k, v in params["dense"].items()}

    def acts(smiles):
        chunks = []
        for i in range(0, len(smiles), batch_size):
            oh = torch.from_numpy(one_hot_smiles(smiles[i:i + batch_size], max_len))
            chunks.append(chemnet_activations(on_device, oh.to(device)).cpu().numpy())
        return np.concatenate(chunks, axis=0)

    return fcd_from_activations(acts(list(gen_smiles)), acts(list(ref_smiles)))
