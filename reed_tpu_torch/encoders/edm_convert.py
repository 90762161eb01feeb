"""EDM weights for the port: reference torch checkpoints and reed_tpu's flax
params.

The reference saves `torch.save(model.state_dict(), 'generative_model.npy')`
(molecule/utils.py:23-24) for an EnVariationalDiffusion holding an
EGNN_dynamics_QM9 (keys `dynamics.egnn.*`, `dynamics.fake_latent`) and, with
noise_schedule 'learned', a GammaNetwork (keys `gamma.l{1,2,3}.*`,
`gamma.gamma_{0,1}`). The port's EGNNDynamics and GammaNetwork carry those
names, so a reference checkpoint loads once the prefixes are stripped
(`split_edm_state_dict`). `state_dict_from_flax` is the inverse of
reed_tpu's converter (reed_tpu/encoders/edm_convert.py): every leaf of
reed_tpu's EGNNDynamics params, fake_latent and the rep cross-attention
stack included, under the port's names; `gamma_state_dict_from_params` the
same for reed_tpu's GammaNetwork dict.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# flax module -> (the port's module path, the names of its children)
_GCL = {"edge_fc1": "edge_mlp.0", "edge_fc2": "edge_mlp.2", "node_fc1": "node_mlp.0",
        "node_fc2": "node_mlp.2", "att": "att_mlp.0"}
_EQUIV = {"coord_fc1": "coord_mlp.0", "coord_fc2": "coord_mlp.2",
          "coord_out": "coord_mlp.4"}
_ATTN = {"norm_attn": "norm2", "to_q": "attn2.to_q", "to_k": "attn2.to_k",
         "to_v": "attn2.to_v", "to_out": "attn2.to_out.0", "norm_ff": "norm3",
         "ff_proj": "ff.net.0.proj", "ff_out": "ff.net.2"}
_ATTN_NAME = re.compile(r"^attn_(\d+)_(\d+)$")
# flax leaf -> (torch leaf, whether the array is transposed)
_LEAVES = {"kernel": ("weight", True), "bias": ("bias", False), "scale": ("weight", False)}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def torch_name(flax_path) -> str:
    """The port's state_dict key of one flax param path (a tuple of names)
    of reed_tpu's EGNNDynamics."""
    if tuple(flax_path) == ("fake_latent",):
        return "fake_latent"
    if flax_path[0] != "egnn" or flax_path[-1] not in _LEAVES:
        raise KeyError(f"no port parameter for flax leaf {'/'.join(flax_path)}")
    modules, leaf = flax_path[1:-1], _LEAVES[flax_path[-1]][0]
    head = modules[0]
    attn = _ATTN_NAME.match(head)
    if attn:
        path = [f"attns.{attn.group(1)}.{attn.group(2)}", _ATTN[modules[1]]]
    elif head.startswith("e_block_"):
        sub = modules[1]
        path = [head, sub, (_EQUIV if sub == "gcl_equiv" else _GCL)[modules[2]]]
    else:
        path = [head]   # embedding, embedding_out
    return ".".join(["egnn"] + path + [leaf])


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu's EGNNDynamics params (a nested dict of arrays) -> the
    port's EGNNDynamics state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            name = torch_name(path + (key,))
            array = np.asarray(value)
            out[name] = _tensor(array.T if _LEAVES.get(key, ("", False))[1] else array)

    walk(params, ())
    return out


def gamma_state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu's GammaNetwork dict (l{i}_w [in, out]) -> the port's
    GammaNetwork state_dict (l{i}.weight [out, in])."""
    out = {}
    for i in (1, 2, 3):
        out[f"l{i}.weight"] = _tensor(np.asarray(params[f"l{i}_w"]).T)
        out[f"l{i}.bias"] = _tensor(params[f"l{i}_b"])
    out["gamma_0"] = _tensor(params["gamma_0"])
    out["gamma_1"] = _tensor(params["gamma_1"])
    return out


def strip_prefix(sd: Mapping, prefix: str = "module.") -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def split_edm_state_dict(sd: Mapping) -> Tuple[Dict, Optional[Dict]]:
    """A reference EnVariationalDiffusion state dict (or a bare dynamics
    one) -> (the EGNNDynamics state_dict, the GammaNetwork's or None for a
    predefined schedule)."""
    sd = strip_prefix(sd)
    dyn = {k[len("dynamics."):]: v for k, v in sd.items() if k.startswith("dynamics.")}
    if not dyn:
        dyn = {k: v for k, v in sd.items() if not k.startswith("gamma.")}
    gamma = {k[len("gamma."):]: v for k, v in sd.items() if k.startswith("gamma.")}
    return dyn, (gamma or None)


def load_torch_edm_checkpoint(path: str) -> Tuple[Dict, Optional[Dict]]:
    """Read a reference generative_model[_ema].npy (a torch pickle) ->
    split_edm_state_dict of it."""
    return split_edm_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_into(model: torch.nn.Module, sd: Mapping):
    """Load `sd` into `model` (on its device), naming what does not fit."""
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(v) for k, v in sd.items()}, strict=False)
    if missing or unexpected:
        raise ValueError(f"the checkpoint does not fit the configured model: missing "
                         f"{sorted(missing)}, unexpected {sorted(unexpected)} (set the "
                         "widths with --set)")
