"""Carry ProteinMPNN-FMIF weights into the port: from reed_tpu's flax
parameters, and from reference PyTorch checkpoints.

`state_dict_from_flax` is the exact inverse of reed_tpu's
`convert_torch_fmif` (reed_tpu/encoders/fmif_convert.py): flax Dense kernels
[in, out] become torch weights [out, in], LayerNorm scale/bias become
weight/bias, and the W_s table is carried as it is.

Both give whole parameters in the reference names; a tensor rank keeps its
shards of them through parallel/mesh.shard_state_dict with PMPNN_TP_RULES,
and ShardPlan.join_state_dict joins a rank's back, so reference weights and
checkpoints stay whole whatever the tensor size.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu ProteinMPNNFMIF params (numpy tree, bare or under 'params')
    -> the port's ProteinMPNNFMIF state_dict."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def dense(key, tree):
        sd[f"{key}.weight"] = np.asarray(tree["kernel"]).T
        if "bias" in tree:
            sd[f"{key}.bias"] = np.asarray(tree["bias"])

    def ln(key, tree):
        sd[f"{key}.weight"] = np.asarray(tree["scale"])
        sd[f"{key}.bias"] = np.asarray(tree["bias"])

    def two_layer(key, tree, names):
        for src, dst in zip(("Dense_0", "Dense_1"), names):
            dense(f"{key}.{dst}", tree[src])

    f = p["features"]
    dense("features.embeddings.linear", f["PositionalEncodings_0"]["Dense_0"])
    dense("features.edge_embedding", f["edge_embedding"])
    ln("features.norm_edges", f["norm_edges"])
    sd["node_embeds"] = np.asarray(p["node_embeds"])
    dense("W_e", p["W_e"])
    sd["W_s.weight"] = np.asarray(p["W_s_embedding"])
    dense("W_out", p["W_out"])
    for name in ("single", "pair", "structure"):
        two_layer(f"projectors_{name}", p[f"projectors_{name}"], ("0", "2"))

    n_enc = sum(1 for k in p if k.startswith("encoder_layers_"))
    for i in range(n_enc):
        lay, pfx = p[f"encoder_layers_{i}"], f"encoder_layers.{i}"
        for w in ("W1", "W2", "W3", "W11", "W12", "W13"):
            dense(f"{pfx}.{w}", lay[w])
        for n in ("norm1", "norm2", "norm3"):
            ln(f"{pfx}.{n}", lay[n])
        two_layer(f"{pfx}.dense", lay["dense"], ("W_in", "W_out"))

    n_dec = sum(1 for k in p if k.startswith("decoder_layers_"))
    for i in range(n_dec):
        lay, pfx = p[f"decoder_layers_{i}"], f"decoder_layers.{i}"
        for w in ("W1", "W2", "W3"):
            dense(f"{pfx}.{w}", lay[w])
        for n in ("norm1", "norm2", "norm_edge"):
            ln(f"{pfx}.{n}", lay[n])
        two_layer(f"{pfx}.dense", lay["dense"], ("W_in", "W_out"))
        # W_edge = Sequential(LayerNorm, Linear, GELU, Linear)
        ln(f"{pfx}.W_edge.0", lay["W_edge_norm"])
        dense(f"{pfx}.W_edge.1", lay["W_edge_fc1"])
        dense(f"{pfx}.W_edge.3", lay["W_edge_fc2"])

    if "cls_embedder" in p:
        sd["cls_embedder.weight"] = np.asarray(p["cls_embedder"]["embedding"])
        for i in range(n_enc):
            dense(f"cls_layers_enc.{i}", p[f"cls_layers_enc_{i}"])
        for i in range(n_dec):
            dense(f"cls_layers_dec.{i}", p[f"cls_layers_dec_{i}"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference fmif .pt checkpoint ({'model_state_dict': state_dict} or a
    bare state_dict) as the port's state_dict: the DDP 'module.' prefix is
    stripped and the derived tied 'W_s_ft' (a copy of W_s) dropped. The file
    is unpickled with weights_only, so it holds tensors and plain data."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("W_s_ft") and isinstance(v, torch.Tensor):
            out[k] = v
    return out
