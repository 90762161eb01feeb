"""Reference MultiFlow checkpoints for the port's FlowModel, and reed_tpu's
FlowModel params carried into it.

The port's FlowModel (models/ipa.py) keeps the reference torch FlowModel's
parameter names and layouts (protein/multiflow/models/flow_model.py:11-62),
so a reference state dict loads unchanged: `load_reference_checkpoint`
only unwraps Lightning's `state_dict`, strips its `model.` prefix and reads
the widths off the tensors, as reed_tpu's convert_torch_multiflow does.

`state_dict_from_flax` is the inverse of reed_tpu's converter
(encoders/multiflow_convert.py there): flax Dense kernels [in, out] become
torch weights [out, in], and the point projections go back from
reed_tpu's interleaved (point, xyz) columns to the reference's three xyz
blocks of H*P columns, as do the point rows of linear_out.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _point_perm(no_heads: int, n_points: int) -> np.ndarray:
    """perm[reed_tpu column] = reference column: (p*3 + d) <- (d*H*P + p)."""
    hp = no_heads * n_points
    return np.array([d * hp + p for p in range(hp) for d in range(3)], np.int64)


def _dense(out: Dict, name: str, tree: Mapping, perm=None):
    kernel, bias = np.asarray(tree["kernel"]), np.asarray(tree["bias"])
    if perm is not None:   # back to the reference's column order
        inv = np.argsort(perm)
        kernel, bias = kernel[:, inv], bias[inv]
    out[f"{name}.weight"] = _tensor(kernel.T)
    out[f"{name}.bias"] = _tensor(bias)


def _ln(out: Dict, name: str, tree: Mapping):
    out[f"{name}.weight"] = _tensor(tree["scale"])
    out[f"{name}.bias"] = _tensor(tree["bias"])


def _ipa(out: Dict, key: str, tree: Mapping):
    heads = np.asarray(tree["head_weights"]).shape[0]
    c_hidden = np.asarray(tree["linear_q"]["kernel"]).shape[1] // heads
    pq = np.asarray(tree["linear_q_points"]["kernel"]).shape[1] // (3 * heads)
    pv = np.asarray(tree["linear_kv_points"]["kernel"]).shape[1] // (3 * heads) - pq
    for name in ("linear_q", "linear_kv", "linear_b", "down_z"):
        _dense(out, f"{key}.{name}", tree[name])
    _dense(out, f"{key}.linear_q_points", tree["linear_q_points"], _point_perm(heads, pq))
    _dense(out, f"{key}.linear_kv_points", tree["linear_kv_points"],
           _point_perm(heads, pq + pv))
    # linear_out's input rows: [o (H*C) | o_pt (H*Pv*3) | norms | pair]; the
    # o_pt rows back to the reference's xyz blocks
    kernel = np.array(tree["linear_out"]["kernel"])
    seg = slice(heads * c_hidden, heads * c_hidden + heads * pv * 3)
    kernel[seg] = kernel[seg][np.argsort(_point_perm(heads, pv))]
    _dense(out, f"{key}.linear_out", {"kernel": kernel, "bias": tree["linear_out"]["bias"]})
    out[f"{key}.head_weights"] = _tensor(tree["head_weights"])


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu's FlowModel params (a nested dict of arrays) -> the port's
    FlowModel state_dict (the reference's names and layouts)."""
    out: Dict[str, torch.Tensor] = {}
    nf = params["node_feature_net"]
    out["node_feature_net.aatype_embedding.weight"] = _tensor(nf["aatype_embed"]["embedding"])
    for i in (0, 2, 4):
        _dense(out, f"node_feature_net.linear.{i}", nf[f"linear_{i}"])
    _ln(out, "node_feature_net.linear.5", nf["linear_ln"])
    ef = params["edge_feature_net"]
    _dense(out, "edge_feature_net.linear_s_p", ef["linear_s_p"])
    _dense(out, "edge_feature_net.linear_relpos", ef["linear_relpos"])
    for i in (0, 2, 4):
        _dense(out, f"edge_feature_net.edge_embedder.{i}", ef[f"embed_{i}"])
    _ln(out, "edge_feature_net.edge_embedder.5", ef["embed_ln"])
    for i, j in ((0, 0), (1, 2), (2, 4)):
        _dense(out, f"aatype_pred_net.{j}", params[f"aatype_pred_{i}"])
    num_blocks = 1 + max(int(k.rsplit("_", 1)[1]) for k in params if k.startswith("ipa_ln_"))
    for b in range(num_blocks):
        t = f"trunk.{{}}_{b}"
        _ipa(out, t.format("ipa"), params[f"ipa_{b}"])
        _ln(out, t.format("ipa_ln"), params[f"ipa_ln_{b}"])
        layers = sorted(int(k.rsplit("_", 1)[1]) for k in params
                        if k.startswith(f"seq_tfmr_{b}_"))
        for li in layers:
            tree, key = params[f"seq_tfmr_{b}_{li}"], f"trunk.seq_tfmr_{b}.layers.{li}"
            out[f"{key}.self_attn.in_proj_weight"] = _tensor(np.asarray(tree["qkv"]["kernel"]).T)
            out[f"{key}.self_attn.in_proj_bias"] = _tensor(tree["qkv"]["bias"])
            _dense(out, f"{key}.self_attn.out_proj", tree["proj"])
            _dense(out, f"{key}.linear1", tree["fc1"])
            _dense(out, f"{key}.linear2", tree["fc2"])
            _ln(out, f"{key}.norm1", tree["ln1"])
            _ln(out, f"{key}.norm2", tree["ln2"])
        _dense(out, t.format("post_tfmr"), params[f"post_tfmr_{b}"])
        tr = params[f"node_transition_{b}"]
        for i in (1, 2, 3):
            _dense(out, f"{t.format('node_transition')}.linear_{i}", tr[f"l{i}"])
        _ln(out, f"{t.format('node_transition')}.ln", tr["ln"])
        _dense(out, f"{t.format('bb_update')}.linear", params[f"bb_update_{b}"]["linear"])
        if f"edge_transition_{b}" in params:
            et, key = params[f"edge_transition_{b}"], t.format("edge_transition")
            _dense(out, f"{key}.initial_embed", et["initial_embed"])
            _dense(out, f"{key}.trunk.0", et["trunk_0"])
            _dense(out, f"{key}.trunk.2", et["trunk_1"])
            _dense(out, f"{key}.final_layer", et["final_layer"])
            _ln(out, f"{key}.layer_norm", et["ln"])
    return out


def strip_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference FlowModel state dict: Lightning's `model.` prefix
    stripped where present (other keys of such a checkpoint dropped)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


def widths(sd: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """The FlowModel widths of a (stripped) reference state dict, read off
    the tensors as reed_tpu's convert_torch_multiflow reads them, under
    MultiflowTrainConfig's field names."""
    heads = sd["trunk.ipa_0.head_weights"].shape[0]
    pq = sd["trunk.ipa_0.linear_q_points.weight"].shape[0] // (heads * 3)
    return {
        "c_s": sd["trunk.ipa_0.linear_q.weight"].shape[1],
        "c_z": sd["trunk.ipa_0.linear_b.weight"].shape[1],
        "num_blocks": 1 + max(int(k.split(".")[1].rsplit("_", 1)[1]) for k in sd
                              if k.startswith("trunk.ipa_ln_")),
        "seq_tfmr_num_layers": 1 + max(int(k.split(".")[3]) for k in sd
                                       if k.startswith("trunk.seq_tfmr_0.layers.")),
        "ipa_c_hidden": sd["trunk.ipa_0.linear_q.weight"].shape[0] // heads,
        "ipa_no_heads": heads,
        "ipa_no_qk_points": pq,
        "ipa_no_v_points": sd["trunk.ipa_0.linear_kv_points.weight"].shape[0] // (heads * 3) - pq,
    }


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """A reference torch FlowModel or Lightning checkpoint file -> (the port
    FlowModel's state_dict, its widths)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    sd = strip_state_dict(ckpt)
    return sd, widths(sd)
