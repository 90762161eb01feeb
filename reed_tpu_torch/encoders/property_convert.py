"""Weights between reed_tpu's property classifier and linear probe (flax
trees) and the port's (torch state_dicts).

reed_tpu has no reference-checkpoint converter for these models, so the
flax tree is the one other layout: each Dense is {kernel [in, out], bias}
and becomes {name}.weight [out, in] and {name}.bias. edge_fc1's kernel
[2d + e, hidden] (reed_tpu's DenseParams, sliced by rows for h_i, h_j and
the edge feature) stays one weight [hidden, 2d + e], sliced by columns in
the same order.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _dense(out: Dict, name: str, tree: Mapping):
    out[f"{name}.weight"] = torch.from_numpy(np.array(tree["kernel"], np.float32).T.copy())
    out[f"{name}.bias"] = torch.from_numpy(np.array(tree["bias"], np.float32))


def _kernel(sd: Mapping[str, torch.Tensor], name: str) -> Dict[str, np.ndarray]:
    return {"kernel": sd[f"{name}.weight"].detach().cpu().numpy().T.copy(),
            "bias": sd[f"{name}.bias"].detach().cpu().numpy().copy()}


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu's PropertyClassifier params (a nested dict of arrays) -> the
    port's PropertyClassifier state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        if name.startswith("gcl_"):
            for sub, leaf in node.items():
                _dense(out, f"{name}.{sub}", leaf)
        else:
            _dense(out, name, node)
    return out


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse: the port's state_dict -> reed_tpu's params tree (numpy)."""
    tree: Dict = {}
    for key in sd:
        if not key.endswith(".weight"):
            continue
        name = key[:-len(".weight")]
        *outer, leaf = name.split(".")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = _kernel(sd, name)
    return tree


def probe_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu's linear probe (nn.Dense(1): {kernel [rep_dim, 1], bias
    [1]}) -> the port's nn.Linear(rep_dim, 1) state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _dense(out, "probe", params)
    return {"weight": out["probe.weight"], "bias": out["probe.bias"]}


def probe_flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of probe_state_dict_from_flax."""
    return _kernel({f"probe.{k}": v for k, v in sd.items()}, "probe")
