"""UniMolGlobal weights for the port: reference torch checkpoints and
reed_tpu's flax params.

The port's UniMolGlobal keeps the reference torch names
(unimol_global.py:170-330 on unicore's TransformerEncoderLayer and
SelfMultiheadAttention), so a reference state dict loads after its prefix
is stripped and the keys of the training-only heads (lm, coordinate and
distance heads, node-feature fusion) are dropped; the widths are read off
the file and every shape is checked. `state_dict_from_flax` maps
reed_tpu's params (separate q/k/v projections) to the port's names (q|k|v
packed into in_proj).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from reed_tpu_torch.encoders.unimol import UniMolGlobal


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu UniMolGlobal params (with or without the 'params'
    collection) -> the port's state_dict."""
    p = params["params"] if "params" in params else params

    def dense(prefix, node):
        return {f"{prefix}.weight": _t(np.asarray(node["kernel"]).T),
                f"{prefix}.bias": _t(node["bias"])}

    def ln(prefix, node):
        return {f"{prefix}.weight": _t(node["scale"]), f"{prefix}.bias": _t(node["bias"])}

    sd = {"embed_tokens.weight": _t(p["embed_tokens"]["embedding"]),
          "gbf.means.weight": _t(p["gbf"]["means"]), "gbf.stds.weight": _t(p["gbf"]["stds"]),
          "gbf.mul.weight": _t(p["gbf"]["mul"]["embedding"]),
          "gbf.bias.weight": _t(p["gbf"]["bias"]["embedding"]),
          **dense("gbf_proj.linear1", p["gbf_proj_fc1"]),
          **dense("gbf_proj.linear2", p["gbf_proj_fc2"]),
          **ln("encoder.emb_layer_norm", p["emb_layer_norm"]),
          **ln("encoder.final_layer_norm", p["final_layer_norm"]),
          **dense("global_rep_head.0", p["global_head_fc1"]),
          **dense("global_rep_head.2", p["global_head_fc2"]),
          **dense("global_rep_head.4", p["global_head_fc3"])}
    i = 0
    while f"layers_{i}" in p:
        lp, pre = p[f"layers_{i}"], f"encoder.layers.{i}"
        qkv = [lp[k] for k in ("q_proj", "k_proj", "v_proj")]
        sd[f"{pre}.self_attn.in_proj.weight"] = _t(np.concatenate(
            [np.asarray(x["kernel"]).T for x in qkv], axis=0))
        sd[f"{pre}.self_attn.in_proj.bias"] = _t(np.concatenate(
            [np.asarray(x["bias"]) for x in qkv]))
        sd.update(dense(f"{pre}.self_attn.out_proj", lp["out_proj"]))
        sd.update(ln(f"{pre}.self_attn_layer_norm", lp["self_attn_layer_norm"]))
        sd.update(ln(f"{pre}.final_layer_norm", lp["final_layer_norm"]))
        sd.update(dense(f"{pre}.fc1", lp["fc1"]))
        sd.update(dense(f"{pre}.fc2", lp["fc2"]))
        i += 1
    return sd


def widths(sd: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """UniMolGlobal's constructor arguments, read off a state dict."""
    emb = sd["embed_tokens.weight"]
    return dict(vocab_size=emb.shape[0], embed_dim=emb.shape[1],
                ffn_dim=sd["encoder.layers.0.fc1.weight"].shape[0],
                heads=sd["gbf_proj.linear2.weight"].shape[0],
                layers=1 + max(int(k.split(".")[2]) for k in sd
                               if k.startswith("encoder.layers.")),
                gaussian_k=sd["gbf.means.weight"].shape[1],
                rep_dim=sd["global_rep_head.4.weight"].shape[0])


def convert_torch_unimol(sd: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference UniMolGlobal state dict -> the port's: `prefix` stripped,
    the keys the global-rep route does not use dropped, shapes checked
    against a model of the widths the file holds."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = {k: torch.as_tensor(v).detach().cpu().float() for k, v in sd.items()}
    own = UniMolGlobal(**widths(sd)).state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} UniMolGlobal parameters, "
                         f"e.g. {missing[:5]}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(f"shapes differ from UniMolGlobal's at {bad[:5]}")
    return {k: sd[k] for k in own}


def load_torch_unimol_checkpoint(path: str, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Load a torch UniMol checkpoint file (a state dict, or one under
    'model' or 'state_dict') and convert it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
    return convert_torch_unimol(ckpt, prefix=prefix)


def unimol_from_state_dict(sd: Mapping[str, torch.Tensor], device=None) -> UniMolGlobal:
    """A UniMolGlobal of the state dict's widths holding its weights."""
    with torch.device(device) if device is not None else torch.device("cpu"):
        model = UniMolGlobal(**widths(sd))
    model.load_state_dict(sd)
    return model.eval()
