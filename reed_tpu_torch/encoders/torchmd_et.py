"""TorchMD-ET equivariant transformer: the frozen "Frad" molecule encoder of
QM9 representation guidance. Counterpart of reed_tpu/encoders/torchmd_et.py
(reference: molecule/models/torchmdnet/models/torchmd_et.py TorchMD_ET and
EquivariantMultiHeadAttention, models/utils.py NeighborEmbedding,
ExpNormalSmearing, CosineCutoff).

Dense-batched as reed_tpu computes it: the edges are the [B, N, N] pair grid
masked by the cutoff radius (no radius graph, no scatter). Expnorm RBFs,
distance-modulated keys and values, SiLU attention scaled by the cosine
cutoff, the value split three ways (scalar, vector gate, direction gate),
vector features updated by gated neighbour vectors and gated unit
directions, the o1/o2/o3 output heads with the vec1 . vec2 inner product.
`FradEncoder` is the global representation: the sum-pooled features,
layer-normed (reference: semlaflow/flowmodels/encoders.py:258-330). f32;
LayerNorms eps 1e-6 (flax's default, which reed_tpu computes with).

Parameters carry the reference torch names (`embedding`,
`distance_expansion.means`, `neighbor_embedding.distance_proj`,
`attention_layers.{i}.q_proj`, `out_norm`, ...), so a reference state dict
('representation_model.' prefix stripped) loads as it is
(`convert_torchmd_et`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def cosine_cutoff(d, cutoff_upper: float = 5.0, cutoff_lower: float = 0.0):
    """Reference: models/utils.py:162-195."""
    if cutoff_lower > 0:
        c = 0.5 * (torch.cos(math.pi * (2 * (d - cutoff_lower) / (cutoff_upper - cutoff_lower)
                                        + 1.0)) + 1.0)
        return c * (d < cutoff_upper) * (d > cutoff_lower)
    return 0.5 * (torch.cos(d * math.pi / cutoff_upper) + 1.0) * (d < cutoff_upper)


class ExpNormalSmearing(nn.Module):
    """PhysNet expnorm RBFs (reference: models/utils.py:109-160)."""

    def __init__(self, num_rbf: int = 50, cutoff_upper: float = 5.0, cutoff_lower: float = 0.0):
        super().__init__()
        self.cutoff_upper, self.cutoff_lower = cutoff_upper, cutoff_lower
        start = math.exp(-cutoff_upper + cutoff_lower)
        # torch.tensor (not from_numpy) follows a torch.device context
        self.means = nn.Parameter(torch.tensor(np.linspace(start, 1.0, num_rbf)
                                               .astype(np.float32)))
        self.betas = nn.Parameter(torch.full((num_rbf,), (2 / num_rbf * (1 - start)) ** -2))

    def forward(self, d):
        alpha = 5.0 / (self.cutoff_upper - self.cutoff_lower)
        cut = cosine_cutoff(d, self.cutoff_upper)
        arg = torch.exp(-alpha * (d[..., None] - self.cutoff_lower)) - self.means
        return cut[..., None] * torch.exp(-self.betas * arg ** 2)


class NeighborEmbedding(nn.Module):
    """Reference: models/utils.py:40-80."""

    def __init__(self, hidden: int, num_rbf: int, max_z: int):
        super().__init__()
        self.embedding = nn.Embedding(max_z, hidden)
        self.distance_proj = nn.Linear(num_rbf, hidden)
        self.combine = nn.Linear(2 * hidden, hidden)


class ETAttention(nn.Module):
    """EquivariantMultiHeadAttention, dense-batched (reference:
    torchmd_et.py:236-380)."""

    def __init__(self, hidden: int = 128, num_heads: int = 8, num_rbf: int = 50,
                 cutoff_upper: float = 5.0):
        super().__init__()
        self.hidden, self.num_heads, self.cutoff_upper = hidden, num_heads, cutoff_upper
        self.layernorm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, 3 * hidden)
        self.o_proj = nn.Linear(hidden, 3 * hidden)
        self.vec_proj = nn.Linear(hidden, 3 * hidden, bias=False)
        self.dk_proj = nn.Linear(num_rbf, hidden)
        self.dv_proj = nn.Linear(num_rbf, 3 * hidden)

    def forward(self, x, vec, d, d_unit, f_ij, edge_mask):
        """x [B,N,H], vec [B,N,3,H], d [B,N,N], d_unit [B,N,N,3], f_ij
        [B,N,N,R], edge_mask [B,N,N] -> (dx, dvec)."""
        b, n, hidden = x.shape
        heads, hd = self.num_heads, hidden // self.num_heads
        x_ln = self.layernorm(x)
        q = self.q_proj(x_ln).reshape(b, n, heads, hd)
        k = self.k_proj(x_ln).reshape(b, n, heads, hd)
        v = self.v_proj(x_ln).reshape(b, n, heads, 3 * hd)
        vec1, vec2, vec3 = torch.chunk(self.vec_proj(vec), 3, dim=-1)
        vec_dot = torch.sum(vec1 * vec2, dim=2)                            # [B,N,H]
        dk = F.silu(self.dk_proj(f_ij)).reshape(b, n, n, heads, hd)
        dv = F.silu(self.dv_proj(f_ij)).reshape(b, n, n, heads, 3 * hd)

        # attn[b,i,j,h] = silu(sum_d q_i k_j dk_ij) * cutoff(d_ij)
        attn = torch.einsum("bihd,bjhd,bijhd->bijh", q, k, dk)
        attn = F.silu(attn) * cosine_cutoff(d, self.cutoff_upper)[..., None]
        attn = attn * edge_mask[..., None]

        s, g_vec, g_dir = torch.chunk(v[:, None] * dv, 3, dim=-1)          # [B,i,j,h,hd]
        dx = torch.einsum("bijh,bijhd->bihd", attn, s).reshape(b, n, hidden)
        vec_h = vec.reshape(b, n, 3, heads, hd)
        dvec = (torch.einsum("bijhd,bjchd->bichd", attn[..., None] * g_vec, vec_h)
                + torch.einsum("bijhd,bijc->bichd", attn[..., None] * g_dir, d_unit))
        dvec = dvec.reshape(b, n, 3, hidden)
        o1, o2, o3 = torch.chunk(self.o_proj(dx), 3, dim=-1)
        return vec_dot * o2 + o3, vec3 * o1[:, :, None, :] + dvec


class TorchMDET(nn.Module):
    """The encoder (reference: torchmd_et.py:16-230): forward(z [B,N] atomic
    numbers, pos [B,N,3], node_mask [B,N]) -> (x [B,N,H], vec [B,N,3,H])."""

    def __init__(self, hidden: int = 128, num_layers: int = 6, num_rbf: int = 50,
                 num_heads: int = 8, cutoff_upper: float = 5.0, max_z: int = 100,
                 neighbor_embedding: bool = True):
        super().__init__()
        self.hidden, self.cutoff_upper = hidden, cutoff_upper
        self.distance_expansion = ExpNormalSmearing(num_rbf, cutoff_upper)
        self.embedding = nn.Embedding(max_z, hidden)
        self.neighbor_embedding = (NeighborEmbedding(hidden, num_rbf, max_z)
                                   if neighbor_embedding else None)
        self.attention_layers = nn.ModuleList(
            ETAttention(hidden, num_heads, num_rbf, cutoff_upper) for _ in range(num_layers))
        self.out_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, z, pos, node_mask):
        b, n = z.shape
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        d = torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-12)
        eye = torch.eye(n, dtype=pos.dtype, device=pos.device)
        pair_mask = node_mask[:, :, None] * node_mask[:, None, :] * (1.0 - eye)[None]
        edge_mask = pair_mask * (d < self.cutoff_upper)
        d_unit = diff / torch.clamp(d[..., None], min=1e-6)
        f_ij = self.distance_expansion(d)
        x = self.embedding(z)
        if self.neighbor_embedding is not None:
            ne = self.neighbor_embedding
            c = cosine_cutoff(d, self.cutoff_upper)
            w = ne.distance_proj(f_ij) * (c * edge_mask)[..., None]
            agg = torch.einsum("bijh,bjh->bih", w, ne.embedding(z))
            x = ne.combine(torch.cat([x, agg], dim=-1))
        vec = torch.zeros((b, n, 3, self.hidden), dtype=x.dtype, device=x.device)
        for layer in self.attention_layers:
            dx, dvec = layer(x, vec, d, d_unit, f_ij, edge_mask)
            x = x + dx
            vec = vec + dvec
        return self.out_norm(x) * node_mask[..., None], vec


class FradEncoder(nn.Module):
    """Frad's global representation: the sum-pooled ET features,
    layer-normed. forward(z, pos, node_mask) -> [B, H]."""

    def __init__(self, et: Optional[TorchMDET] = None):
        super().__init__()
        self.et = et if et is not None else TorchMDET()
        self.rep_norm = nn.LayerNorm(self.et.hidden, eps=LN_EPS)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """Seeded weights (the encoder is frozen and normally loaded): N(0,
        0.05) linears and embeddings, N(0, 0.02) biases, the RBF means and
        betas at the reference's initialisation, unit LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, std=0.05, generator=generator)
                if getattr(m, "bias", None) is not None:
                    nn.init.normal_(m.bias, std=0.02, generator=generator)
        return self

    def forward(self, z, pos, node_mask):
        x, _ = self.et(z, pos, node_mask)
        return self.rep_norm(torch.sum(x * node_mask[..., None], dim=1))


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """reed_tpu TorchMDET or FradEncoder params (with or without the 'params'
    collection) -> the port's state_dict (FradEncoder's when the tree has
    'et'); the inverse of reed_tpu's convert_torchmd_et."""
    p = params["params"] if "params" in params else params

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    def dense(name, node):
        out = {f"{name}.weight": t(np.asarray(node["kernel"]).T)}
        if "bias" in node:
            out[f"{name}.bias"] = t(node["bias"])
        return out

    def ln(name, node):
        return {f"{name}.weight": t(node["scale"]), f"{name}.bias": t(node["bias"])}

    if "et" in p:
        return {**{f"et.{k}": v for k, v in state_dict_from_flax(p["et"]).items()},
                **ln("rep_norm", p["rep_norm"])}
    sd = {"embedding.weight": t(p["embedding"]["embedding"]),
          "distance_expansion.means": t(p["distance_expansion"]["means"]),
          "distance_expansion.betas": t(p["distance_expansion"]["betas"]),
          **ln("out_norm", p["out_norm"])}
    if "neighbor_embedding" in p:
        sd["neighbor_embedding.embedding.weight"] = t(p["neighbor_embedding"]["embedding"])
        sd.update(dense("neighbor_embedding.distance_proj", p["neighbor_distance_proj"]))
        sd.update(dense("neighbor_embedding.combine", p["combine"]))
    i = 0
    while f"attention_layers_{i}" in p:
        lp, pre = p[f"attention_layers_{i}"], f"attention_layers.{i}"
        sd.update(ln(f"{pre}.layernorm", lp["layernorm"]))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "vec_proj", "dk_proj", "dv_proj"):
            sd.update(dense(f"{pre}.{name}", lp[name]))
        i += 1
    return sd


def convert_torchmd_et(state_dict: Mapping, prefix: str = "representation_model."
                       ) -> Dict[str, torch.Tensor]:
    """A reference TorchMD_ET state dict (under `prefix`, as Frad's
    checkpoints hold it, or already stripped) -> the port's TorchMDET
    state_dict: the names are the port's, so this strips the prefix and
    keeps the encoder's keys."""
    sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    keep = ("embedding.", "distance_expansion.", "neighbor_embedding.", "attention_layers.",
            "out_norm.")
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).float()
            for k, v in sd.items() if k.startswith(keep)}


def et_widths(sd: Mapping[str, torch.Tensor]) -> Dict:
    """TorchMDET's constructor arguments read off a state dict (num_heads is
    not in the weights: the reference's 8 unless given)."""
    emb = sd["embedding.weight"]
    return dict(hidden=emb.shape[1], max_z=emb.shape[0],
                num_rbf=sd["distance_expansion.means"].shape[0],
                num_layers=1 + max(int(k.split(".")[1]) for k in sd
                                   if k.startswith("attention_layers.")),
                neighbor_embedding="neighbor_embedding.embedding.weight" in sd)


def load_torchmd_et_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A Frad / TorchMD-Net checkpoint file (a state dict or one under
    'state_dict') as the port's TorchMDET state_dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return convert_torchmd_et(ckpt)


def frad_from_state_dict(sd: Mapping[str, torch.Tensor], num_heads: int = 8,
                         cutoff_upper: float = 5.0, device=None) -> FradEncoder:
    """A FradEncoder holding a TorchMDET state dict (the 'et.' keys of a
    FradEncoder's, or a bare TorchMDET's, whose rep_norm stays at its unit
    initialisation, as reed_tpu's converter leaves it)."""
    et_sd = ({k[3:]: v for k, v in sd.items() if k.startswith("et.")}
             or {k: v for k, v in sd.items() if not k.startswith("rep_norm.")})
    with torch.device(device) if device is not None else torch.device("cpu"):
        model = FradEncoder(TorchMDET(**et_widths(et_sd), num_heads=num_heads,
                                      cutoff_upper=cutoff_upper))
    model.et.load_state_dict(et_sd)
    if "rep_norm.weight" in sd:
        model.rep_norm.load_state_dict({"weight": sd["rep_norm.weight"],
                                        "bias": sd["rep_norm.bias"]})
    return model.eval()
