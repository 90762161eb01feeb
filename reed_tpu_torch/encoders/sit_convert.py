"""Carry SiT weights into the port: from reed_tpu's flax parameters, and
from reference PyTorch checkpoints.

`state_dict_from_flax` is the exact inverse of reed_tpu's
`convert_torch_sit` (reed_tpu/encoders/sit_convert.py): flax Dense kernels
[in, out] become torch weights [out, in], and the patch-embedding kernel over
row-major (p, p, C) patches becomes the reference conv weight [D, C, p, p].
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def state_dict_from_flax(params: Mapping, patch_size: int) -> Dict[str, torch.Tensor]:
    """reed_tpu SiT params (numpy tree, bare or under 'params') -> the port's
    SiT state_dict."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, tree):
        sd[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
        if "bias" in tree:
            sd[f"{prefix}.bias"] = np.asarray(tree["bias"])

    kernel = np.asarray(p["x_embedder"]["kernel"])  # [p*p*C, D]
    d_model = kernel.shape[1]
    c = kernel.shape[0] // (patch_size * patch_size)
    sd["x_embedder.proj.weight"] = kernel.reshape(
        patch_size, patch_size, c, d_model).transpose(3, 2, 0, 1)
    sd["x_embedder.proj.bias"] = np.asarray(p["x_embedder"]["bias"])

    dense("t_embedder.mlp.0", p["t_embedder"]["Dense_0"])
    dense("t_embedder.mlp.2", p["t_embedder"]["Dense_1"])
    sd["y_embedder.embedding_table.weight"] = np.asarray(
        p["y_embedder"]["Embed_0"]["embedding"])

    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        blk, pfx = p[f"blocks_{i}"], f"blocks.{i}"
        dense(f"{pfx}.adaLN_modulation.1", blk["adaLN_modulation"])
        dense(f"{pfx}.attn.qkv", blk["attn"]["qkv"])
        dense(f"{pfx}.attn.proj", blk["attn"]["proj"])
        dense(f"{pfx}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"{pfx}.mlp.fc2", blk["mlp"]["fc2"])

    n_proj = sum(1 for k in p if k.startswith("projectors_"))
    for j in range(n_proj):
        proj = p[f"projectors_{j}"]
        for src, dst in (("Dense_0", 0), ("Dense_1", 2), ("Dense_2", 4)):
            dense(f"projectors.{j}.{dst}", proj[src])

    dense("final_layer.adaLN_modulation.1", p["final_layer"]["adaLN_modulation"])
    dense("final_layer.linear", p["final_layer"]["linear"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_reference_checkpoint(path: str, model_key: str = "ema"
                              ) -> Dict[str, torch.Tensor]:
    """A reference .pt checkpoint ({model|ema: state_dict} or a bare
    state_dict) as the port's SiT state_dict: the DDP 'module.' prefix is
    stripped and the fixed 'pos_embed' (recomputed by SiT) dropped.
    The file is unpickled, so load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt[model_key] if model_key in ckpt else ckpt
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if k != "pos_embed" and isinstance(v, torch.Tensor):
            out[k] = v
    return out
