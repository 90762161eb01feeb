"""Semla: SE(3)-equivariant message passing with multiple learnable
coordinate sets, for molecular flow matching (SemlaFlow), with REED
representation conditioning (cross-attn / adaLN) and alignment projectors.
Counterpart of reed_tpu/models/semla.py (reference:
molecule/semlaflow/flowmodels/semla.py), in f32 or in reed_tpu's mixed
precision.

Parameters carry the reference torch SemlaFlow's names
(`dynamics.layers.{i}.message_ff.message_mlp.0`, `feat_proj.0`,
`atom_classifier_head.0`, ...), the keys reed_tpu's checkpoint converter
reads; `size_emb` has max_atoms + 1 rows (the reference has max_atoms; the
index n_atoms = max_atoms is then in range). The numerics follow reed_tpu:
LayerNorms take eps 1e-6 (flax's default; the reference torch model's is
1e-5), the RepConditioner's norms have no scale and no bias and its gated
feed-forward uses tanh GELU, the coordinate attention is the factored gram
form (the [B,3,N,N,P] difference tensor is never built), lengths are
sqrt(sum + 1e-12) and coordinates feeding pair features are clamped at
+-COORD_CLAMP.

Layouts: node features [B, N, d], pair features [B, N, N, c], and the
multi-set coordinates [B, N, 3, S] with the set dim trailing, so every
set-dim projection is a Linear over the last axis.

Mixed precision (SemlaGenerator's compute_dtype bfloat16, reed_tpu's
`dtype`): the feature and message path computes in bf16, each f32 weight
cast where it is used as flax's Dense(dtype=...) casts it, LayerNorms take
f32 statistics and return bf16; every coordinate-valued tensor stays f32
(CoordAttention, NodeFeedForward's coordinate half, the coordinate head),
and so do the attention softmaxes, the rep conditioning, the alignment
projectors and the returned logits.

Tensor parallelism (SemlaGenerator's `parallel`, a parallel.mesh
DataParallel with tensor T above 1; parallel/mesh.SEMLA_TP_RULES): a rank
holds T-th shards of four kinds of Megatron column/row pairs and does its
share of their work. The edge-message MLPs (each layer's and BondRefine's) keep
their first product factored over the rank's hidden columns and return
f32 partial messages that the tensor group sums once before the second
product's bias is added; the node inputs and the pair inputs (grams and
edge features) enter through copy_to_tensor, so their partial gradients
are summed once in the backward. The node attention takes a rank's heads
(in_proj's columns, out_proj's rows): its logits are its heads of the
summed messages, which enter through copy_to_tensor, since the message
MLP's second product needs every head's gradient. The invariant node
feed-forwards (node_ff, final_ff_block) and the input feature projection
are column/row pairs. The coordinate paths, the rep conditioning, the
norms, the edge in/out projections and the heads are whole on every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import (ProjectorMLP, TimestepEmbedder, dense, layer_norm,
                                      row_dense, split_width, tensor_size)
from reed_tpu_torch.parallel.collectives import copy_to_tensor

NEG_INF = -1e9
# coordinate-magnitude ceiling where raw (norm "none") coordinates feed
# pairwise geometry features; far above any healthy scale (O(1-30)), it
# bounds the init-time self-conditioning transient (reed_tpu's COORD_CLAMP)
COORD_CLAMP = 3e2
LN_EPS = 1e-6  # flax's LayerNorm default, which reed_tpu trains with


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


def _mlp(d_in: int, d_hidden: int, d_out: int) -> nn.Sequential:
    """Linear -> SiLU -> Linear (keys 0 and 2, as the reference's)."""
    return nn.Sequential(nn.Linear(d_in, d_hidden), nn.SiLU(), nn.Linear(d_hidden, d_out))


def _run_mlp(mlp: nn.Sequential, x, dtype: torch.dtype, parallel=None):
    """mlp(x) in `dtype`; under the tensor axis of `parallel` mlp holds a
    rank's column/row shards: x enters through copy_to_tensor and the f32
    partials of the second product are summed before its bias is added
    (nn/layers.row_dense)."""
    h = F.silu(dense(copy_to_tensor(x.to(dtype), parallel), mlp[0], dtype))
    return row_dense(h, mlp[2], dtype, parallel)


class _Mixed(nn.Module):
    """A Semla module whose feature path computes in `compute_dtype`, set
    on every submodule by SemlaGenerator."""

    compute_dtype = torch.float32


def safe_norm(x, dim=-1, keepdim=False, eps: float = 1e-12):
    """||x|| as sqrt(sum + eps): a finite gradient at 0, where masked nodes
    and i == j difference vectors sit."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def zero_com(coords, node_mask):
    """coords [..., N, 3], node_mask [..., N] -> zero masked center of mass."""
    mask = node_mask[..., None]
    n = torch.clamp(torch.sum(mask, dim=-2, keepdim=True), min=1.0)
    com = torch.sum(coords * mask, dim=-2, keepdim=True) / n
    return (coords - com) * mask


def zero_com_sets(coord_sets, node_mask):
    """coord_sets [B,N,3,S], node_mask [B,N] -> zero masked center of mass
    per coordinate set."""
    mask = node_mask[:, :, None, None]
    n = torch.clamp(torch.sum(node_mask, dim=1), min=1.0)[:, None, None, None]
    com = torch.sum(coord_sets * mask, dim=1, keepdim=True) / n
    return (coord_sets - com) * mask


def adj_from_node_mask(node_mask, self_connect: bool = False):
    """Fully connected adjacency among real nodes [B,N] -> [B,N,N]."""
    adj = node_mask[:, :, None] * node_mask[:, None, :]
    if not self_connect:
        n = node_mask.shape[-1]
        adj = adj * (1.0 - torch.eye(n, device=adj.device, dtype=adj.dtype))[None]
    return adj


def _attn_mask_from_adj(adj):
    """0/1 adjacency -> additive attention mask; a node with no connection
    (a padded atom) gets an all-zero row, so its softmax stays finite."""
    mask = torch.where(adj == 0, NEG_INF, 0.0)
    n_connections = torch.sum(adj, dim=-1, keepdim=True)
    return torch.where(n_connections == 0, 0.0, mask)


def _factored_pair_mlp(mlp: nn.Sequential, nf, pair, dm: int, dtype: torch.dtype,
                       parallel=None):
    """mlp(concat([nf_i, nf_j, pair_ij])) in `dtype` with the first Linear
    split by input rows: the two node parts run as [B,N,dm] products before
    the broadcast, and the [B,N,N,2dm+c] concat is never built. Under the
    tensor axis of `parallel` mlp holds a rank's hidden columns and the
    matching rows of the second product: nf and pair enter through
    copy_to_tensor, and the rank's f32 partial messages are summed over the
    tensor group before the second bias is added."""
    nf, pair = copy_to_tensor(nf, parallel), copy_to_tensor(pair, parallel)
    w1, b1 = mlp[0].weight.to(dtype), mlp[0].bias.to(dtype)
    x = ((nf @ w1[:, :dm].T)[:, :, None, :] + (nf @ w1[:, dm:2 * dm].T)[:, None, :, :]
         + pair @ w1[:, 2 * dm:].T + b1)
    return row_dense(F.silu(x), mlp[2], dtype, parallel)


class CoordNorm(nn.Module):
    """Coordinate-set normalisation, kinds none | gvp | length. The set
    weights keep the reference's (1, S, 1, 1) shape and apply on the
    trailing set dim."""

    def __init__(self, n_coord_sets: int, norm: str = "length", eps: float = 1e-6):
        super().__init__()
        if norm not in ("length", "gvp", "none"):
            raise ValueError(norm)
        self.n_coord_sets, self.norm, self.eps = n_coord_sets, norm, eps
        self.set_weights = nn.Parameter(torch.ones((1, n_coord_sets, 1, 1)))

    def forward(self, coord_sets, node_mask):
        # coord_sets [B,N,3,S], node_mask [B,N]
        sw = self.set_weights.reshape(1, 1, 1, self.n_coord_sets)
        coord_sets = zero_com_sets(coord_sets, node_mask)
        out = coord_sets * sw
        if self.norm != "none":
            lengths = safe_norm(coord_sets, dim=2)                        # [B,N,S]
            if self.norm == "length":
                n_atoms = torch.clamp(torch.sum(node_mask, dim=1), min=1.0)[:, None, None]
                scaled = torch.sum(lengths, dim=1, keepdim=True) / n_atoms
                coord_div = scaled[:, :, None, :] + self.eps              # [B,1,1,S]
            else:
                coord_div = (lengths[:, :, None, :] + self.eps) / math.sqrt(self.n_coord_sets)
            out = out / coord_div
        return out * node_mask[:, :, None, None]


class EdgeMessages(_Mixed):
    """Pairwise messages from node pairs and per-set coordinate dot products
    (reference: semla.py:103-166)."""

    def __init__(self, d_model: int, d_message: int, d_out: int, n_coord_sets: int,
                 d_ff: Optional[int] = None, d_edge: Optional[int] = None, parallel=None):
        super().__init__()
        d_ff = d_ff or d_out
        self.d_message = d_message
        self.parallel = parallel
        self.node_norm = _layer_norm(d_model)
        self.coord_norm = CoordNorm(n_coord_sets, norm="none")
        self.node_proj = nn.Linear(d_model, d_message)
        self.edge_norm = _layer_norm(d_edge) if d_edge is not None else None
        self.message_mlp = _mlp(2 * d_message + n_coord_sets + (d_edge or 0),
                                split_width(d_ff, tensor_size(parallel), "the message MLP"),
                                d_out)

    def forward(self, coords, node_feats, node_mask, edge_feats=None):
        dt = self.compute_dtype
        node_feats = layer_norm(node_feats, self.node_norm, dt)
        coords = torch.clamp(self.coord_norm(coords, node_mask), -COORD_CLAMP, COORD_CLAMP)
        # per-set coordinate gram matrices in [B,N,M,S] order
        pair = [torch.einsum("bnds,bmds->bnms", coords, coords).to(dt)]
        if edge_feats is not None:
            pair.append(layer_norm(edge_feats, self.edge_norm, dt))
        pair = torch.cat(pair, dim=-1) if len(pair) > 1 else pair[0]
        return _factored_pair_mlp(self.message_mlp, dense(node_feats, self.node_proj, dt),
                                  pair, self.d_message, dt, self.parallel)


class NodeAttention(_Mixed):
    """Message-as-attention-logits node update with GNN-VPA weighting
    (reference: semla.py:169-225)."""

    def __init__(self, d_model: int, n_attn_heads: int, parallel=None):
        super().__init__()
        self.parallel = parallel
        # this rank's heads: in_proj's columns and out_proj's rows of them
        self.local_heads = split_width(n_attn_heads, tensor_size(parallel),
                                       "the node attention heads")
        d_local = self.local_heads * (d_model // n_attn_heads)
        self.feat_norm = _layer_norm(d_model)
        self.in_proj = nn.Linear(d_model, d_local)
        self.out_proj = nn.Linear(d_local, d_model)

    def forward(self, node_feats, messages, adj_matrix):
        """messages: [B,N,N,H], every head's logits (the summed messages
        under the tensor axis; a rank takes its own heads)."""
        b, n, d = node_feats.shape
        h, dt, parallel = self.local_heads, self.compute_dtype, self.parallel
        x = copy_to_tensor(layer_norm(node_feats, self.feat_norm, dt), parallel)
        if tensor_size(parallel) > 1:
            first = parallel.tensor_index * h
            messages = copy_to_tensor(messages, parallel)[..., first:first + h]
        logits = messages.float() + _attn_mask_from_adj(adj_matrix)[..., None]
        attn = torch.softmax(logits, dim=2)                               # over j
        feats = dense(x, self.in_proj, dt)
        hd = feats.shape[-1] // h
        out = torch.einsum("bijh,bjhd->bihd", attn.to(dt), feats.reshape(b, n, h, hd))
        # variance-preserving aggregation (GNN-VPA)
        weights = torch.sqrt(torch.sum(attn ** 2, dim=2))                 # [B,N,H]
        out = (out * weights[..., None].to(dt)).reshape(b, n, h * hd)
        return row_dense(out, self.out_proj, dt, parallel)


def _coord_attention_updates(proj, attn, eps):
    """sum_j attn_ij (x_i - x_j) / (|x_i - x_j| + eps), factored:

      lengths by the gram identity |xi-xj|^2 = |xi|^2 + |xj|^2 - 2 xi.xj
      w_ij = attn_ij / (|xi-xj| + eps)
      sum_j w_ij (xi - xj) = xi * sum_j w_ij - sum_j w_ij xj

    The i == j term is exactly zero in the difference form; in the factored
    form it is two large equal terms, so w's diagonal is zeroed explicitly.
    proj [B,N,3,P], attn [B,i,j,P] -> updates [B,N,3,P]."""
    n = proj.shape[1]
    sq = torch.sum(proj * proj, dim=2)                                    # [B,N,P]
    inner = torch.einsum("bidp,bjdp->bijp", proj, proj)                   # [B,i,j,P]
    dist2 = sq[:, :, None] + sq[:, None, :] - 2.0 * inner
    lengths = torch.sqrt(torch.clamp(dist2, min=0.0) + 1e-12)
    w = attn / (lengths + eps)
    w = w * (1.0 - torch.eye(n, device=w.device, dtype=w.dtype))[None, :, :, None]
    wsum = torch.sum(w, dim=2)                                            # [B,i,P]
    return proj * wsum[:, :, None, :] - torch.einsum("bijp,bjdp->bidp", w, proj)


class CoordAttention(nn.Module):
    """Equivariant coordinate update by attention over normalised pairwise
    direction vectors (reference: semla.py:228-278)."""

    def __init__(self, n_coord_sets: int, proj_sets: Optional[int] = None,
                 coord_norm: str = "length", eps: float = 1e-6):
        super().__init__()
        p = proj_sets or n_coord_sets
        self.eps = eps
        self.coord_norm = CoordNorm(n_coord_sets, norm=coord_norm)
        self.coord_proj = nn.Linear(n_coord_sets, p, bias=False)
        self.attn_proj = nn.Linear(p, n_coord_sets, bias=False)

    def forward(self, coord_sets, messages, adj_matrix, node_mask):
        # the coordinate-valued path stays f32 in mixed precision
        proj = self.coord_proj(self.coord_norm(coord_sets, node_mask))  # [B,N,3,P]
        logits = messages.float() + _attn_mask_from_adj(adj_matrix)[..., None]
        attn = torch.softmax(logits, dim=2)                               # [B,i,j,P]
        updates = _coord_attention_updates(proj, attn, self.eps)
        weights = torch.sqrt(torch.sum(attn ** 2, dim=2))                 # [B,i,P]
        return self.attn_proj(updates * weights[:, :, None, :])           # [B,N,3,S]


class _LengthsMLP(nn.Module):
    def __init__(self, d_in: int, d_ff: int, d_out: int):
        super().__init__()
        self.node_ff = _mlp(d_in, d_ff, d_out)


class _EquivariantMLP(nn.Module):
    def __init__(self, d_model: int, n_coord_sets: int, p: int):
        super().__init__()
        self.node_proj = _mlp(d_model, p, p)
        self.coord_proj = nn.Linear(n_coord_sets, p, bias=False)
        self.attn_proj = nn.Linear(p, n_coord_sets, bias=False)


class NodeFeedForward(_Mixed):
    """Invariant (lengths MLP) and equivariant (gated projected sets)
    feed-forward (reference: semla.py:281-372)."""

    def __init__(self, d_model: int, n_coord_sets: int, d_ff: Optional[int] = None,
                 proj_sets: Optional[int] = None, coord_norm: str = "length",
                 parallel=None):
        super().__init__()
        p = proj_sets or n_coord_sets
        self.parallel = parallel
        self.node_norm = _layer_norm(d_model)
        self.coord_norm = CoordNorm(n_coord_sets, norm=coord_norm)
        self.invariant_mlp = _LengthsMLP(
            d_model + n_coord_sets,
            split_width(d_ff or 4 * d_model, tensor_size(parallel), "the node feed-forward"),
            d_model)
        self.equivariant_mlp = _EquivariantMLP(d_model, n_coord_sets, p)

    def forward(self, coord_sets, node_feats, node_mask):
        dt = self.compute_dtype
        node_feats = layer_norm(node_feats, self.node_norm, dt)
        coord_sets = self.coord_norm(coord_sets, node_mask)
        lengths = safe_norm(coord_sets, dim=2)                            # [B,N,S]
        out_node = _run_mlp(self.invariant_mlp.node_ff,
                            torch.cat([node_feats, lengths.to(dt)], dim=-1), dt, self.parallel)
        eq = self.equivariant_mlp
        # the gates may be low precision; the coordinate-valued half stays f32
        gates = _run_mlp(eq.node_proj, node_feats, dt).float()
        proj = eq.coord_proj(coord_sets)                                  # [B,N,3,P]
        # the outer product of the gates with the projected sets, summed
        # over the projected axis, is rank 1: gates * proj.sum(q)
        attn = gates[:, :, None, :] * torch.sum(proj, dim=-1, keepdim=True)
        return eq.attn_proj(attn), out_node


class BondRefine(_Mixed):
    """Final bond-only message-passing refinement (reference:
    semla.py:375-430)."""

    def __init__(self, d_model: int, d_message: int, d_edge: int, d_ff: Optional[int] = None,
                 parallel=None):
        super().__init__()
        self.d_message = d_message
        self.parallel = parallel
        self.coord_norm = CoordNorm(1, norm="none")
        self.node_norm = _layer_norm(d_model)
        self.node_proj = nn.Linear(d_model, d_message)
        self.edge_norm = _layer_norm(d_edge)
        self.message_mlp = _mlp(2 * d_message + 2 + d_edge,
                                split_width(d_ff or d_message, tensor_size(parallel),
                                            "the bond refinement's message MLP"), d_edge)

    def forward(self, coords, node_feats, node_mask, edge_feats):
        coords = torch.clamp(self.coord_norm(coords[..., None], node_mask)[..., 0],
                             -COORD_CLAMP, COORD_CLAMP)
        dt = self.compute_dtype
        diffs = coords[:, :, None, :] - coords[:, None, :, :]
        dists = torch.sum(diffs ** 2, dim=-1, keepdim=True)
        dots = torch.einsum("bnd,bmd->bnm", coords, coords)[..., None]
        nf = dense(layer_norm(node_feats, self.node_norm, dt), self.node_proj, dt)
        pair = torch.cat([dists.to(dt), dots.to(dt),
                          layer_norm(edge_feats, self.edge_norm, dt)], dim=-1)
        return _factored_pair_mlp(self.message_mlp, nf, pair, self.d_message, dt, self.parallel)


def _norm_no_affine(x, dtype: torch.dtype = torch.float32):
    """flax's LayerNorm(use_bias=False, use_scale=False, dtype=...): f32
    statistics, the output in `dtype`."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=LN_EPS).to(dtype)


class RepConditioner(nn.Module):
    """Rep conditioning block: cross_attn (context length 1) or adaLN-zero
    (reference: flowmodels/attention.py:151-291). Its norms have no scale
    and no bias; the gated feed-forward uses tanh GELU (flax's nn.gelu).
    forward's `dtype` is reed_tpu's `dtype` of the block: the products and
    the stream in it, the softmaxes in f32 (the SemlaGenerator runs it in
    f32; the alternative generators in their compute dtype)."""

    def __init__(self, cond_type: str, d_model: int, d_rep: int, n_heads: int = 4):
        super().__init__()
        self.cond_type, self.n_heads = cond_type, n_heads
        d = d_model
        if cond_type == "cross_attn":
            self.to_q = nn.Linear(d, d, bias=False)
            self.to_k = nn.Linear(d_rep, d, bias=False)
            self.to_v = nn.Linear(d_rep, d, bias=False)
            self.to_out = nn.Linear(d, d)
        elif cond_type == "adaLN":
            self.adaLN_modulation = nn.Linear(d_rep, 6 * d)
            self.attn_qkv = nn.Linear(d, 3 * d, bias=False)
            self.attn_out = nn.Linear(d, d)
        else:
            raise ValueError(cond_type)
        self.ff_proj = nn.Linear(d, 2 * 4 * d)
        self.ff_out = nn.Linear(4 * d, d)

    def _gated_ff(self, h, dtype):
        a, g = torch.chunk(dense(h, self.ff_proj, dtype), 2, dim=-1)
        return dense(a * F.gelu(g, approximate="tanh"), self.ff_out, dtype)

    def forward(self, x, rep, node_mask1d, dtype: torch.dtype = torch.float32):
        b, n, d = x.shape
        h, hd = self.n_heads, d // self.n_heads
        if self.cond_type == "cross_attn":
            ctx = rep[:, None, :]
            q = dense(_norm_no_affine(x, dtype), self.to_q, dtype).reshape(b, n, h, hd)
            k = dense(ctx, self.to_k, dtype).reshape(b, 1, h, hd)
            v = dense(ctx, self.to_v, dtype).reshape(b, 1, h, hd)
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
            attn = torch.softmax(logits.float(), dim=-1).to(dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
            x = x + dense(out.reshape(b, n, d), self.to_out, dtype)
            x = x + self._gated_ff(_norm_no_affine(x, dtype), dtype)
        else:
            mod = dense(F.silu(rep), self.adaLN_modulation, dtype)[:, None, :]
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
            y = _norm_no_affine(x, dtype) * (1 + sc_a) + sh_a
            q, k, v = (t.reshape(b, n, h, hd)
                       for t in torch.chunk(dense(y, self.attn_qkv, dtype), 3, dim=-1))
            logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
            # mask padded keys: their logits would otherwise draw e^0 weight
            pad = torch.where(node_mask1d > 0, 0.0, -1e9)[:, None, None, :]
            attn = torch.softmax(logits.float() + pad, dim=-1).to(dtype)
            o = torch.einsum("bhnm,bmhd->bnhd", attn, v)
            x = x + g_a * dense(o.reshape(b, n, d), self.attn_out, dtype)
            y = _norm_no_affine(x, dtype) * (1 + sc_m) + sh_m
            x = x + g_m * self._gated_ff(y, dtype)
        return x * node_mask1d[..., None]


class EquiMessagePassingLayer(_Mixed):
    """Core Semla layer (reference: semla.py:433-576)."""

    def __init__(self, d_model: int, d_message: int, n_coord_sets: int,
                 n_attn_heads: Optional[int] = None, d_message_hidden: Optional[int] = None,
                 d_edge_in: Optional[int] = None, d_edge_out: Optional[int] = None,
                 coord_norm: str = "length", d_rep: Optional[int] = None,
                 cond_type: str = "none", parallel=None):
        super().__init__()
        self.n_heads = n_attn_heads or d_message
        self.n_coord_sets = n_coord_sets
        self.d_edge_out = d_edge_out
        d_message_out = self.n_heads + n_coord_sets + (d_edge_out or 0)
        self.rep_cond = (RepConditioner(cond_type, d_model, d_rep)
                         if cond_type != "none" and d_rep is not None else None)
        self.node_ff = NodeFeedForward(d_model, n_coord_sets, d_ff=4 * d_model,
                                       proj_sets=d_message, coord_norm=coord_norm,
                                       parallel=parallel)
        self.message_ff = EdgeMessages(d_model, d_message, d_message_out, n_coord_sets,
                                       d_ff=d_message_hidden, d_edge=d_edge_in,
                                       parallel=parallel)
        self.node_attn = NodeAttention(d_model, self.n_heads, parallel)
        self.coord_attn = CoordAttention(n_coord_sets, n_coord_sets, coord_norm=coord_norm)

    def forward(self, coords, node_feats, adj_matrix, node_mask, edge_feats=None, rep=None):
        if rep is not None and self.rep_cond is not None:
            # the conditioning block stays f32 in mixed precision
            node_feats = self.rep_cond(node_feats.float(), rep.float(),
                                       node_mask).to(self.compute_dtype)
        c_up, n_up = self.node_ff(coords, node_feats, node_mask)
        coords = coords + c_up
        node_feats = node_feats + n_up
        messages = self.message_ff(coords, node_feats, node_mask, edge_feats=edge_feats)
        h, s = self.n_heads, self.n_coord_sets
        node_feats = node_feats + self.node_attn(node_feats, messages[..., :h], adj_matrix)
        coords = coords + self.coord_attn(coords, messages[..., h:h + s], adj_matrix,
                                          node_mask)
        if self.d_edge_out is None:
            return coords, node_feats, None
        edge_out = messages[..., h + s:]
        if edge_feats is not None:
            edge_out = edge_feats + edge_out
        return coords, node_feats, edge_out


class EquiInvDynamics(_Mixed):
    """Stack of Semla layers with edge in/out layers, the self-conditioning
    coordinate channel, the rep's time embedding and the alignment
    projectors (reference: semla.py:579-819). With `coord_skip` the
    coordinate head predicts a residual off the input state (no parameters
    of its own)."""

    def __init__(self, d_model: int, d_message: int, n_coord_sets: int, n_layers: int,
                 n_attn_heads: Optional[int] = None, d_message_hidden: Optional[int] = None,
                 d_edge: Optional[int] = None, bond_refine: bool = True,
                 self_cond: bool = False, coord_norm: str = "length",
                 d_rep: Optional[int] = None, cond_type: str = "none",
                 rep_alignment: bool = False, align_depth: Sequence[int] = (6,),
                 d_projector: Optional[int] = None, coord_skip: bool = False,
                 parallel=None):
        super().__init__()
        self.coord_skip = coord_skip
        self.time_embedder = (TimestepEmbedder(d_rep, frequency_embedding_size=512)
                              if d_rep is not None else None)
        self.coord_proj = nn.Linear(2 if self_cond else 1, n_coord_sets, bias=False)
        common = dict(d_model=d_model, d_message=d_message, n_coord_sets=n_coord_sets,
                      n_attn_heads=n_attn_heads, coord_norm=coord_norm, d_rep=d_rep,
                      cond_type=cond_type, parallel=parallel)
        layers = []
        if d_edge is not None:
            layers.append(EquiMessagePassingLayer(d_edge_in=d_edge, **common))
        n_core = n_layers - (2 if d_edge is not None else 0)
        layers += [EquiMessagePassingLayer(d_message_hidden=d_message_hidden, **common)
                   for _ in range(n_core)]
        if d_edge is not None:
            layers.append(EquiMessagePassingLayer(d_edge_out=d_edge, **common))
        self.layers = nn.ModuleList(layers)
        # the layers (by index) whose node features go through a projector
        self.align_layers = ([i for i in range(len(layers)) if i in tuple(align_depth)]
                             if rep_alignment else [])
        self.projectors = nn.ModuleList(
            ProjectorMLP(d_model, d_projector or d_model, d_rep) for _ in self.align_layers)
        self.final_ff_block = NodeFeedForward(d_model, n_coord_sets, coord_norm=coord_norm,
                                              parallel=parallel)
        self.coord_norm = CoordNorm(n_coord_sets, norm=coord_norm)
        self.coord_head = nn.Linear(n_coord_sets, 1, bias=False)
        self.refine_layer = (BondRefine(d_model, d_message, d_edge, parallel=parallel)
                             if bond_refine and d_edge is not None else None)
        self.feat_norm = _layer_norm(d_model)
        self.bond_norm = _layer_norm(d_edge) if d_edge is not None else None

    def forward(self, coords, inv_feats, adj_matrix, atom_mask, edge_feats=None,
                cond_coords=None, rep=None, times=None):
        coords_in = coords
        dt = self.compute_dtype
        if rep is not None and times is not None:
            rep = rep + self.time_embedder(times, dt)
        # one (or the self-conditioning pair of) coordinate channel(s) -> S sets
        stacked = (torch.stack([coords, cond_coords], dim=-1) if cond_coords is not None
                   else coords[..., None])
        coords = self.coord_proj(stacked) * atom_mask[:, :, None, None]   # [B,N,3,S]

        zs, edge_out = [], None
        for i, layer in enumerate(self.layers):
            coords, inv_feats, edge_out = layer(
                coords, inv_feats, adj_matrix, atom_mask,
                edge_feats=edge_feats if i == 0 else None, rep=rep)
            if i in self.align_layers:
                proj = self.projectors[self.align_layers.index(i)]
                zs.append(proj(torch.sum(inv_feats.float(), dim=1)))       # sum-pooled

        coords, inv_feats = self.final_ff_block(coords, inv_feats, atom_mask)
        out_coords = self.coord_head(self.coord_norm(coords, atom_mask))[..., 0]  # [B,N,3]
        if self.coord_skip:
            out_coords = out_coords + coords_in
        if self.refine_layer is not None:
            edge_out = self.refine_layer(out_coords, inv_feats, atom_mask, edge_out)
        inv_feats = layer_norm(inv_feats, self.feat_norm, dt)
        if self.bond_norm is not None:
            edge_out = layer_norm(edge_out, self.bond_norm, dt)
        return out_coords, inv_feats, edge_out, zs


class SemlaGenerator(_Mixed):
    """The molecular generator (reference: semla.py:822-995): size
    embedding, feature and edge projections, the dynamics, the type / charge
    heads and symmetric edge logits; zero-CoM coordinates.

    forward(coords [B,N,3], inv_feats [B,N,V], edge_feats [B,N,N,E] (iff
    d_edge), cond_coords / cond_atomics / cond_bonds (the self-conditioning
    inputs, iff self_cond), atom_mask [B,N], rep [B,d_rep], times [B]) ->
    (coords, type_logits, bond_logits or None, charge_logits, zs), the
    coordinates and logits f32. compute_dtype bfloat16 is reed_tpu's mixed
    precision, `parallel` the tensor axis (the module docstring): the
    parameters are then a tensor rank's shards, whose names stay the
    whole model's (parallel/mesh.shard_state_dict)."""

    def __init__(self, d_model: int, vocab_size: int, n_atom_feats: int,
                 d_edge: Optional[int] = None, n_edge_types: Optional[int] = None,
                 self_cond: bool = False, size_emb: int = 64, max_atoms: int = 256,
                 n_charge_types: int = 7, rep_alignment: bool = False,
                 d_message: int = 64, n_coord_sets: int = 64, n_layers: int = 12,
                 n_attn_heads: Optional[int] = None, d_message_hidden: Optional[int] = None,
                 coord_norm: str = "length", d_rep: Optional[int] = None,
                 cond_type: str = "none", align_depth: Sequence[int] = (4,),
                 d_projector: Optional[int] = None, coord_skip: bool = False,
                 compute_dtype: torch.dtype = torch.float32, parallel=None):
        super().__init__()
        self.self_cond = self_cond
        self.parallel = parallel
        self.size_emb = nn.Embedding(max_atoms + 1, size_emb)
        self.feat_proj = _mlp(n_atom_feats + size_emb + (vocab_size if self_cond else 0),
                              split_width(d_model, tensor_size(parallel),
                                          "the feature projection"),
                              d_model)
        if d_edge is not None:
            self.edge_in_proj = _mlp(n_edge_types * (2 if self_cond else 1), d_edge, d_edge)
            self.edge_out_proj = _mlp(d_edge, d_edge, n_edge_types)
        else:
            self.edge_in_proj = self.edge_out_proj = None
        self.dynamics = EquiInvDynamics(
            d_model=d_model, d_message=d_message, n_coord_sets=n_coord_sets,
            n_layers=n_layers, n_attn_heads=n_attn_heads,
            d_message_hidden=d_message_hidden, d_edge=d_edge, self_cond=self_cond,
            coord_norm=coord_norm, d_rep=d_rep, cond_type=cond_type,
            rep_alignment=rep_alignment, align_depth=align_depth,
            d_projector=d_projector, coord_skip=coord_skip, parallel=parallel)
        self.atom_classifier_head = _mlp(d_model, d_model, vocab_size)
        self.charge_classifier_head = _mlp(d_model, d_model, n_charge_types)
        for m in self.modules():
            if isinstance(m, _Mixed):
                m.compute_dtype = compute_dtype

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's (flax's default) initialisation: lecun-normal linears
        (a normal truncated at 2 sigma, scaled to variance 1/fan_in) with
        zero biases, xavier-uniform projectors, an N(0, 1/width) size table,
        unit LayerNorms and coordinate-set weights."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for proj in self.dynamics.projectors:
            for m in proj:
                if isinstance(m, nn.Linear):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
        nn.init.normal_(self.size_emb.weight, std=self.size_emb.weight.shape[1] ** -0.5,
                        generator=generator)
        return self

    def forward(self, coords, inv_feats, edge_feats=None, cond_coords=None,
                cond_atomics=None, cond_bonds=None, atom_mask=None, rep=None, times=None):
        b, n, _ = coords.shape
        if atom_mask is None:
            atom_mask = torch.ones((b, n), dtype=coords.dtype, device=coords.device)
        dt = self.compute_dtype
        adj_matrix = adj_from_node_mask(atom_mask)
        n_atoms = torch.sum(atom_mask, dim=-1).long()
        size_emb = F.embedding(n_atoms, self.size_emb.weight.to(dt))[:, None, :].expand(b, n, -1)
        feats = [inv_feats.to(dt), size_emb] + (
            [cond_atomics.to(dt)] if cond_atomics is not None else [])
        atom_feats = _run_mlp(self.feat_proj, torch.cat(feats, dim=-1), dt, self.parallel)
        e = None
        if edge_feats is not None:
            e = edge_feats if cond_bonds is None else torch.cat([edge_feats, cond_bonds], -1)
            e = _run_mlp(self.edge_in_proj, e, dt)

        pred_coords, pred_feats, pred_edges, zs = self.dynamics(
            coords, atom_feats, adj_matrix, atom_mask, edge_feats=e,
            cond_coords=cond_coords, rep=rep, times=times)
        pred_coords = zero_com(pred_coords.float(), atom_mask)
        type_logits = _run_mlp(self.atom_classifier_head, pred_feats, dt).float()
        charge_logits = _run_mlp(self.charge_classifier_head, pred_feats, dt).float()
        bond_logits = None
        if pred_edges is not None:
            bond_logits = _run_mlp(self.edge_out_proj, pred_edges + pred_edges.transpose(1, 2),
                                   dt).float()
        return pred_coords, type_logits, bond_logits, charge_logits, zs
