"""SemlaFlow weights for the port: reference torch checkpoints and
reed_tpu's flax params.

The port's SemlaGenerator names its parameters as the reference torch
SemlaFlow does (molecule/semlaflow/flowmodels/semla.py:822-995; Lightning
checkpoints store them under `gen.` / `ema_gen.module.`), so a reference
state dict loads after two changes: the prefix is stripped and `size_emb`
gets a zero row (the reference's Embedding(max_atoms) cannot index
n_atoms = max_atoms; the port's table has max_atoms + 1 rows, as
reed_tpu's). `state_dict_from_flax` maps every leaf of reed_tpu's flax
params, the RepConditioner's and the time embedding's included, to the
port's names; it carries the trees of reed_tpu's VanillaEgnnGenerator and
EqgatGenerator as well, whose port (models/semla_alt.py) keeps the flax
module names (`layers_{i}` becomes `layers.{i}`, a ProjectorMLP's Dense_k
its Sequential index, nothing else is renamed).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# flax module names -> the port's (reference torch) module paths
_RENAMES = {
    "feat_proj_fc1": "feat_proj.0", "feat_proj_fc2": "feat_proj.2",
    "atom_head_fc1": "atom_classifier_head.0", "atom_head_fc2": "atom_classifier_head.2",
    "charge_head_fc1": "charge_classifier_head.0",
    "charge_head_fc2": "charge_classifier_head.2",
    "edge_in_fc1": "edge_in_proj.0", "edge_in_fc2": "edge_in_proj.2",
    "edge_out_fc1": "edge_out_proj.0", "edge_out_fc2": "edge_out_proj.2",
    "time_emb_fc1": "time_embedder.mlp.0", "time_emb_fc2": "time_embedder.mlp.2",
    "inv_fc1": "invariant_mlp.node_ff.0", "inv_fc2": "invariant_mlp.node_ff.2",
    "equi_node_fc1": "equivariant_mlp.node_proj.0",
    "equi_node_fc2": "equivariant_mlp.node_proj.2",
    "equi_coord_proj": "equivariant_mlp.coord_proj",
    "equi_attn_proj": "equivariant_mlp.attn_proj",
    "message_fc1": "message_mlp.0", "message_fc2": "message_mlp.2",
    "Dense_0": "0", "Dense_1": "2", "Dense_2": "4",   # ProjectorMLP
}
_INDEXED = re.compile(r"^(layers|projectors)_(\d+)$")
# flax leaf -> (torch leaf, whether the array is transposed)
_LEAVES = {"kernel": ("weight", True), "bias": ("bias", False),
           "scale": ("weight", False), "embedding": ("weight", False),
           "set_weights": ("set_weights", False)}


def torch_name(flax_path) -> str:
    """The port's state_dict key of one flax param path (a tuple of names)."""
    *modules, leaf = flax_path
    if leaf not in _LEAVES:
        raise KeyError(f"no port parameter for flax leaf {'/'.join(flax_path)}")
    parts = []
    for m in modules:
        indexed = _INDEXED.match(m)
        parts.append(f"{indexed.group(1)}.{indexed.group(2)}" if indexed
                     else _RENAMES.get(m, m))
    return ".".join(parts + [_LEAVES[leaf][0]])


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu SemlaGenerator, VanillaEgnnGenerator or EqgatGenerator params
    (a nested dict of arrays, with or without the 'params' collection) -> the port's state_dict, one entry per
    flax leaf; load it with strict=True to show that nothing is left over."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(path, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        arr = np.array(node, np.float32)
        name = torch_name(path)
        if name in out:
            raise KeyError(f"two flax leaves map to {name}")
        out[name] = torch.from_numpy(np.ascontiguousarray(
            arr.T if _LEAVES[path[-1]][1] else arr))

    walk((), params)
    return out


def convert_torch_semla(sd: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference SemlaGenerator state dict -> the port's: `prefix` (e.g.
    'gen.' or 'ema_gen.module.') stripped, size_emb padded by a zero row."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
    table = out["size_emb.weight"]
    out["size_emb.weight"] = torch.cat([table, torch.zeros_like(table[:1])], dim=0)
    return out


def load_torch_semla_checkpoint(path: str, prefix: Optional[str] = None,
                                ema: bool = True) -> Dict[str, torch.Tensor]:
    """Load a torch / Lightning SemlaFlow checkpoint file and convert it.
    The MolecularCFM prefix is detected: 'ema_gen.module.' (preferred with
    ema=True), 'ema_gen.', 'gen.' or none."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if prefix is None:
        candidates = (["ema_gen.module.", "ema_gen."] if ema else []) + ["gen.", ""]
        prefix = next((c for c in candidates
                       if any(k.startswith(c + "dynamics.") for k in ckpt)), "")
    return convert_torch_semla(ckpt, prefix=prefix)


def load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]):
    """Copy a converted reference state dict into `model`: every parameter
    of the model must be in it (dims must match, e.g. via --set); keys the
    model lacks are ignored, as reed_tpu's converter ignores them."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} of the model's "
                         f"parameters, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own})
