"""E(n)-equivariant graph network (EGNN) for molecular diffusion, with
representation conditioning (GeoRCG/REED) by cross-attention onto a global
rep. Counterpart of reed_tpu/models/egnn.py (reference:
molecule/egnn/egnn_new.py:6-260, molecule/egnn/models.py:10-160), in f32
or, with compute_dtype bfloat16, as reed_tpu's `dtype` computes.

Parameters carry the reference torch EGNN_dynamics_QM9's names
(`egnn.embedding`, `egnn.e_block_{i}.gcl_{j}.edge_mlp.0`,
`gcl_equiv.coord_mlp.4`, `egnn.attns.{i}.{k}.attn2.to_q`, `fake_latent`,
...), the keys reed_tpu's converter (encoders/edm_convert.py) reads, so a
reference `generative_model.npy` loads without renaming.

Dense-batched like reed_tpu: node features [B, N, d], pair tensors
[B, N, N, c], masked reductions. The first layer of the edge and coordinate
MLPs acts on concat([h_i, h_j, edge_attr]); it is computed through the
column blocks of its one weight, the two node parts as [B, N, d] products
before broadcasting, so the [B, N, N, 2d + e] concat is never built (exact
up to summation order). The rep cross-attention attends to a context of
length 1, where the softmax is exactly 1: its output is the value
projection (to_q, to_k and norm2 take no part and get zero gradients, as
they do in reed_tpu's einsum form).

With compute_dtype bfloat16 every Linear computes as flax's
Dense(dtype=bf16) does, its f32 weights cast where they are used, and the
LayerNorms return bf16 from f32 statistics; the masks are f32, so (as in
JAX) the masked node features, the messages' first layer and its sums,
the coordinates and the outputs stay f32.

Tensor parallelism (EGNNDynamics' `parallel`, a parallel.mesh
DataParallel with tensor T above 1; parallel/mesh.EGNN_TP_RULES): each
GCL's edge and node MLPs, each EquivariantUpdate's first two coordinate
products and each rep block's GEGLU feed-forward are Megatron column/row
pairs. A rank holds the first product's hidden columns (the edge and
coordinate ones stay factored over them) and the second's matching rows;
the inputs enter through copy_to_tensor (their partial gradients are
summed once in the backward), the second product's f32 partials are
summed over the tensor group before its bias and the SiLU, and
everything after the sum (att_mlp, the aggregation, the coordinate head
coord_mlp.4) is whole on every rank. The GEGLU's proj emits the halves
[a, g] of 4d each: a rank holds the same columns of both halves.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import dense, layer_norm, row_dense, split_width, tensor_size
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.collectives import copy_to_tensor


def coord2diff(x, norm_constant: float = 1.0):
    """x [B,N,3] -> (radial [B,N,N,1], coord_diff [B,N,N,3] normalised)."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    radial = torch.sum(diff ** 2, dim=-1, keepdim=True)
    norm = torch.sqrt(radial + 1e-8)
    return radial, diff / (norm + norm_constant)


def remove_mean_with_mask(x, node_mask):
    """Zero the masked centre of mass; x [B,N,D], node_mask [B,N,1]
    (reference: molecule/equivariant_diffusion/utils.py:31-43)."""
    n = torch.sum(node_mask, dim=1, keepdim=True)
    mean = torch.sum(x * node_mask, dim=1, keepdim=True) / n
    return (x - mean) * node_mask


class _Mixed(nn.Module):
    """An EGNN module computing in `compute_dtype`, set on every submodule
    by EGNNDynamics."""

    compute_dtype = torch.float32


def factored_pair_linear(layer: nn.Linear, h, edge_attr, dtype: torch.dtype = torch.float32):
    """layer(concat([h_i, h_j, edge_attr])) [B,N,N,out] from h [B,N,d] and
    edge_attr [B,N,N,e], through the weight's column blocks, with the
    weight and bias in `dtype`. As in JAX, an f32 h meets the rounded
    weight in f32 (type promotion), and the result takes the wider dtype."""
    d = h.shape[-1]
    w = layer.weight.to(dtype)
    wh = w.to(h.dtype)
    hi = F.linear(h, wh[:, :d])
    hj = F.linear(h, wh[:, d:2 * d])
    return (hi[:, :, None, :] + hj[:, None, :, :]
            + F.linear(edge_attr.to(dtype), w[:, 2 * d:], layer.bias.to(dtype)))


class GCL(_Mixed):
    """Graph convolution (feature) layer (reference: egnn_new.py:6-68)."""

    def __init__(self, hidden_nf: int, edges_in_d: int, attention: bool = False,
                 normalization_factor: float = 100.0, aggregation: str = "sum",
                 parallel=None):
        super().__init__()
        self.normalization_factor = normalization_factor
        self.aggregation = aggregation
        self.parallel = parallel
        edge_hidden = split_width(hidden_nf, tensor_size(parallel), "the edge MLP")
        node_hidden = split_width(hidden_nf, tensor_size(parallel), "the node MLP")
        self.edge_mlp = nn.Sequential(nn.Linear(2 * hidden_nf + edges_in_d, edge_hidden),
                                      nn.SiLU(), nn.Linear(edge_hidden, hidden_nf), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * hidden_nf, node_hidden), nn.SiLU(),
                                      nn.Linear(node_hidden, hidden_nf))
        self.attention = attention
        if attention:
            self.att_mlp = nn.Sequential(nn.Linear(hidden_nf, 1), nn.Sigmoid())

    def forward(self, h, edge_attr, node_mask, edge_mask):
        dt, parallel = self.compute_dtype, self.parallel
        m = F.silu(factored_pair_linear(self.edge_mlp[0], copy_to_tensor(h, parallel),
                                        copy_to_tensor(edge_attr, parallel), dt))
        m = F.silu(row_dense(m, self.edge_mlp[2], dt, parallel))
        if self.attention:
            m = m * torch.sigmoid(dense(m, self.att_mlp[0], dt))
        agg = torch.sum(m * edge_mask, dim=2)
        if self.aggregation == "sum":
            agg = agg / self.normalization_factor
        elif self.aggregation == "mean":
            agg = agg / torch.clamp(torch.sum(edge_mask, dim=2), min=1.0)
        out = dense(copy_to_tensor(torch.cat([h, agg], dim=-1), parallel), self.node_mlp[0], dt)
        out = row_dense(F.silu(out), self.node_mlp[2], dt, parallel)
        return (h + out) * node_mask


class EquivariantUpdate(_Mixed):
    """Coordinate update layer (reference: egnn_new.py:71-108)."""

    def __init__(self, hidden_nf: int, edges_in_d: int, tanh: bool = False,
                 coords_range: float = 10.0, normalization_factor: float = 100.0,
                 aggregation: str = "sum", parallel=None):
        super().__init__()
        self.tanh = tanh
        self.coords_range = coords_range
        self.normalization_factor = normalization_factor
        self.aggregation = aggregation
        self.parallel = parallel
        hidden = split_width(hidden_nf, tensor_size(parallel), "the coordinate MLP")
        self.coord_mlp = nn.Sequential(
            nn.Linear(2 * hidden_nf + edges_in_d, hidden), nn.SiLU(),
            nn.Linear(hidden, hidden_nf), nn.SiLU(),
            nn.Linear(hidden_nf, 1, bias=False))

    def forward(self, h, x, coord_diff, edge_attr, node_mask, edge_mask):
        dt, parallel = self.compute_dtype, self.parallel
        m = F.silu(factored_pair_linear(self.coord_mlp[0], copy_to_tensor(h, parallel),
                                        copy_to_tensor(edge_attr, parallel), dt))
        m = F.silu(row_dense(m, self.coord_mlp[2], dt, parallel))
        scalar = dense(m, self.coord_mlp[4], dt)
        if self.tanh:
            trans = coord_diff * torch.tanh(scalar) * self.coords_range
        else:
            trans = coord_diff * scalar
        agg = torch.sum(trans * edge_mask, dim=2)
        if self.aggregation == "sum":
            agg = agg / self.normalization_factor
        return (x + agg) * node_mask


class _CrossAttention(nn.Module):
    """The reference's attn2 (models/attention.py CrossAttention): q from the
    nodes, k and v from the rep, to_out.0 the output projection."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])


class _GEGLU(_Mixed):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        a, gate = dense(x, self.proj, self.compute_dtype).chunk(2, dim=-1)
        return a * F.gelu(gate)   # exact (erf) GELU, as the reference's GEGLU


class _FeedForward(_Mixed):
    """The GEGLU feed-forward; under the tensor axis of `parallel` a rank
    holds `proj`'s columns c_t of both halves [a, g] and the matching rows
    of net.2 (EGNN_TP_RULES' two groups)."""

    def __init__(self, dim: int, mult: int = 4, parallel=None):
        super().__init__()
        self.parallel = parallel
        hidden = split_width(mult * dim, tensor_size(parallel), "the rep feed-forward")
        self.net = nn.ModuleList([_GEGLU(dim, hidden), nn.Identity(),
                                  nn.Linear(hidden, dim)])

    def forward(self, x):
        h = self.net[0](copy_to_tensor(x, self.parallel))
        return row_dense(h, self.net[2], self.compute_dtype, self.parallel)


class RepCrossAttention(_Mixed):
    """Cross-attention of node features onto a global rep, then a GEGLU
    feed-forward, each residual (reference: models/attention.py:151-216
    BasicTransformerBlock without self-attention; LayerNorm eps 1e-5)."""

    def __init__(self, dim: int, context_dim: int, parallel=None):
        super().__init__()
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = _CrossAttention(dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = _FeedForward(dim, parallel=parallel)

    def forward(self, h, rep, node_mask):
        dt = self.compute_dtype
        # one key: softmax(q k^T) = 1, so each head's output is its value
        v = dense(rep, self.attn2.to_v, dt)[:, None, :]
        h = h + dense(v, self.attn2.to_out[0], dt)
        h = h + self.ff(layer_norm(h, self.norm3, dt))
        return h * node_mask


class EquivariantBlock(_Mixed):
    def __init__(self, hidden_nf: int, edge_feat_nf: int = 2, n_layers: int = 2,
                 attention: bool = True, tanh: bool = False, coords_range: float = 15.0,
                 norm_constant: float = 1.0, normalization_factor: float = 100.0,
                 aggregation: str = "sum", parallel=None):
        super().__init__()
        self.n_layers = n_layers
        self.norm_constant = norm_constant
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", GCL(hidden_nf, edge_feat_nf, attention,
                                            normalization_factor, aggregation, parallel))
        self.gcl_equiv = EquivariantUpdate(hidden_nf, edge_feat_nf, tanh, coords_range,
                                           normalization_factor, aggregation, parallel)

    def forward(self, h, x, node_mask, edge_mask, edge_attr):
        distances, coord_diff = coord2diff(x, self.norm_constant)
        edge_attr = torch.cat([distances.to(self.compute_dtype), edge_attr], dim=-1)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, edge_attr, node_mask, edge_mask)
        x = self.gcl_equiv(h, x, coord_diff, edge_attr, node_mask, edge_mask)
        return h * node_mask, x


class EGNN(_Mixed):
    def __init__(self, in_node_nf: int, hidden_nf: int = 256, out_node_nf: Optional[int] = None,
                 n_layers: int = 9, inv_sublayers: int = 2, attention: bool = True,
                 tanh: bool = True, coords_range: float = 15.0, norm_constant: float = 1.0,
                 normalization_factor: float = 100.0, aggregation: str = "sum",
                 rep_nf: Optional[int] = None, attn_block_num: int = 1, parallel=None):
        super().__init__()
        out_node_nf = out_node_nf or in_node_nf
        self.n_layers = n_layers
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        self.embedding_out = nn.Linear(hidden_nf, out_node_nf)
        coords_range_layer = float(coords_range / n_layers)
        for i in range(n_layers):
            self.add_module(f"e_block_{i}", EquivariantBlock(
                hidden_nf, 2, inv_sublayers, attention, tanh, coords_range_layer,
                norm_constant, normalization_factor, aggregation, parallel))
        self.attns = None
        if rep_nf is not None:
            self.attns = nn.ModuleList([
                nn.ModuleList([RepCrossAttention(hidden_nf, rep_nf, parallel)
                               for _ in range(attn_block_num)])
                for _ in range(n_layers)])

    def forward(self, h, x, node_mask, edge_mask, rep=None):
        """h [B,N,F_in], x [B,N,3], node_mask [B,N,1], edge_mask [B,N,N,1],
        rep [B,R] or None -> (h_out [B,N,F_out], x_out [B,N,3])."""
        dt = self.compute_dtype
        distances, _ = coord2diff(x)
        h = dense(h, self.embedding, dt) * node_mask
        for i in range(self.n_layers):
            if self.attns is not None and rep is not None:
                for block in self.attns[i]:
                    h = block(h, rep, node_mask)
            h, x = getattr(self, f"e_block_{i}")(h, x, node_mask, edge_mask,
                                                  distances.to(dt))
        return dense(h, self.embedding_out, dt) * node_mask, x


class EGNNDynamics(nn.Module):
    """Diffusion dynamics around the EGNN (reference: molecule/egnn/models.py
    EGNN_dynamics_QM9): time (and an optional per-node context) appended to
    the node features, the output [velocity, h] with the velocity's centre
    of mass removed. With rep_nf and rep_dropout_prob > 0 a learned
    `fake_latent` replaces the rep of dropped rows in training, and
    `forward_with_cfg` guides with it: cond + w * (cond - uncond).
    `parallel` splits the EGNN over its tensor axis (the module docstring):
    the parameters are then a tensor rank's shards under the whole model's
    names (parallel/mesh.shard_state_dict)."""

    def __init__(self, in_node_nf: int, context_node_nf: int = 0, n_dims: int = 3,
                 hidden_nf: int = 256, n_layers: int = 9, inv_sublayers: int = 2,
                 attention: bool = True, tanh: bool = True, coords_range: float = 15.0,
                 norm_constant: float = 1.0, normalization_factor: float = 100.0,
                 aggregation: str = "sum", condition_time: bool = True,
                 rep_nf: Optional[int] = None, rep_dropout_prob: float = 0.1,
                 attn_block_num: int = 1, compute_dtype: torch.dtype = torch.float32,
                 parallel=None):
        super().__init__()
        self.in_node_nf = in_node_nf
        self.context_node_nf = context_node_nf
        self.n_dims = n_dims
        self.condition_time = condition_time
        self.rep_nf = rep_nf
        self.rep_dropout_prob = rep_dropout_prob
        in_nf = in_node_nf + context_node_nf + int(condition_time)
        self.egnn = EGNN(in_nf, hidden_nf, in_nf, n_layers, inv_sublayers, attention, tanh,
                         coords_range, norm_constant, normalization_factor, aggregation,
                         rep_nf, attn_block_num, parallel)
        if rep_nf is not None and rep_dropout_prob > 0:
            self.fake_latent = nn.Parameter(torch.zeros(1, rep_nf))
        for m in self.modules():
            if isinstance(m, _Mixed):
                m.compute_dtype = compute_dtype

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's (flax's default) initialisation: lecun-normal linears (a
        normal truncated at 2 sigma, scaled to variance 1/fan_in) with zero
        biases, unit LayerNorms and fake_latent N(0, 0.02); the coordinate
        heads as reed_tpu's variance_scaling(1e-3 ** 2 * 2, "fan_avg",
        "uniform"): uniform on +-sqrt(3 * 2e-6 / ((fan_in + fan_out) / 2)),
        which is xavier-uniform at gain sqrt(2) * 1e-3 (the reference torch
        EDM's gain 1e-3 bounds them sqrt(2) times tighter)."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if name.endswith("coord_mlp.4"):
                    fan_in, fan_out = m.weight.shape[1], m.weight.shape[0]
                    a = math.sqrt(3.0 * 2e-6 / ((fan_in + fan_out) / 2.0))
                    nn.init.uniform_(m.weight, -a, a, generator=generator)
                    continue
                std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        if hasattr(self, "fake_latent"):
            nn.init.normal_(self.fake_latent, std=0.02, generator=generator)
        return self

    def forward(self, t, xh, node_mask, edge_mask, context=None, rep=None,
                train: bool = False, drop=None, generator: Optional[torch.Generator] = None):
        """t [B] or a scalar, xh [B,N,3+nf], node_mask [B,N,1], edge_mask
        [B,N,N,1] -> [B,N,3+nf]. In training with rep dropout, the rows where
        `drop` (bool [B]) is True take fake_latent; without `drop` it is
        drawn Bernoulli(rep_dropout_prob) from `generator`."""
        b, n, _ = xh.shape
        xh = xh * node_mask
        x = xh[:, :, :self.n_dims]
        h = xh[:, :, self.n_dims:]
        if h.shape[-1] == 0:
            h = torch.ones((b, n, 1), dtype=xh.dtype, device=xh.device)
        if self.condition_time:
            t = torch.as_tensor(t, dtype=h.dtype, device=h.device)
            h = torch.cat([h, t.reshape(-1, 1, 1).expand(b, n, 1)], dim=-1)
        if context is not None:
            h = torch.cat([h, context * node_mask], dim=-1)
        if rep is not None and hasattr(self, "fake_latent") and train:
            if drop is None:
                drop = draws.rand((b,), generator=generator, device=rep.device) \
                    < self.rep_dropout_prob
            rep = torch.where(torch.as_tensor(drop, device=rep.device).reshape(b, 1),
                              self.fake_latent, rep)
        h_final, x_final = self.egnn(h, x, node_mask, edge_mask, rep=rep)
        vel = (x_final - x) * node_mask
        if context is not None:
            h_final = h_final[:, :, :h_final.shape[-1] - self.context_node_nf]
        if self.condition_time:
            h_final = h_final[:, :, :-1]
        vel = remove_mean_with_mask(vel, node_mask)
        if self.in_node_nf == 0:
            return vel
        return torch.cat([vel, h_final], dim=-1)

    def forward_with_cfg(self, t, xh, node_mask, edge_mask, context, rep, cfg_scale: float):
        """Classifier-free guidance at inference: the conditional and the
        fake_latent passes as one batch of 2B; cond + w * (cond - uncond)
        (reference: models.py:65-84)."""
        b = xh.shape[0]
        t = torch.as_tensor(t, dtype=xh.dtype, device=xh.device).reshape(-1).expand(b)
        fake = self.fake_latent.expand(rep.shape)
        out = self(torch.cat([t, t]), torch.cat([xh, xh]),
                   torch.cat([node_mask, node_mask]), torch.cat([edge_mask, edge_mask]),
                   None if context is None else torch.cat([context, context]),
                   torch.cat([rep, fake]))
        cond, uncond = out.chunk(2, dim=0)
        return cond + cfg_scale * (cond - uncond)
