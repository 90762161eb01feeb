"""The alternative generators of the SemlaFlow pipeline: a vanilla EGNN
generator and an EQGAT-style gated equivariant generator. Counterpart of
reed_tpu/models/semla_alt.py (reference: molecule/semlaflow/flowmodels/
egnn.py VanillaEgnn*, eqgat.py Eqgat*).

Both return SemlaGenerator's outputs (coords, type_logits, bond_logits,
charge_logits, zs), so `SemlaTrainConfig.arch` = egnn | eqgat swaps them in
(reference: semlaflow/train.py:120-160). Parameters carry reed_tpu's flax
module names (`layers.{i}.phi_e_fc1`, `feat_proj`, `bond_fc1`, ...), so
encoders/semla_convert.state_dict_from_flax carries reed_tpu's params over;
the first message Linears over concat([h_i, h_j, e_ij]) are applied by
slices of their weight (the node parts as [B, N, d] products before the
broadcast), so the [B, N, N, 2d + e] concatenation is never built. A layer
holds a cross-attention rep-conditioning block wherever d_rep is set (the
parameter tree reed_tpu's trainer initialises) and runs it when a rep is
passed.

compute_dtype bfloat16 follows flax's dtype rules as reed_tpu computes
them: each Linear casts its input and weight to it, LayerNorms take f32
statistics and return it, and where reed_tpu mixes a bf16 tensor with an
f32 one (the masks, the coordinates, the factored products of an f32
stream) the result is f32, as jnp promotes it; every coordinate-valued
tensor stays f32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.models.semla import LN_EPS, RepConditioner, adj_from_node_mask, zero_com
from reed_tpu_torch.nn.layers import ProjectorMLP, dense, layer_norm


def _pmm(a, w):
    """a @ w with jnp's promotion: a bf16 operand meets an f32 one in f32."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _cat(xs):
    """torch.cat after jnp.concatenate's promotion."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=-1)


def _sqrd_dists(coords):
    diff = coords[:, :, None, :] - coords[:, None, :, :]
    return torch.sum(diff ** 2, dim=-1, keepdim=True), diff


def _factored_fc1(layer: nn.Linear, h, e_in, dtype):
    """layer(concat([h_i, h_j, e_in_ij])) in `dtype`, by slices of the
    weight: (h W_i)_i + (h W_j)_j + e_in W_e + b."""
    d = h.shape[-1]
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    return (_pmm(h, w[:, :d].T)[:, :, None] + _pmm(h, w[:, d:2 * d].T)[:, None, :]
            + e_in @ w[:, 2 * d:].T + b)


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class VanillaEgnnLayer(nn.Module):
    """Squared-distance edge messages with sigmoid attention and a scalar
    coordinate update along normalised differences (reference:
    semlaflow/flowmodels/egnn.py:14-198)."""

    def __init__(self, d_model: int, d_edge: int, d_pred_edge: Optional[int] = None,
                 norm: bool = False, d_rep: Optional[int] = None):
        super().__init__()
        d, e_in = d_model, d_edge + 1
        self.d_model, self.d_pred_edge = d_model, d_pred_edge
        self.rep_cond = (RepConditioner("cross_attn", d_model, d_rep)
                         if d_rep is not None else None)
        self.phi_e_fc1 = nn.Linear(2 * d + e_in, d)
        self.phi_e_fc2 = nn.Linear(d, d + (d_pred_edge or 0))
        self.phi_att = nn.Linear(d, 1)
        self.phi_h_fc1 = nn.Linear(2 * d, d)
        self.phi_h_fc2 = nn.Linear(d, d)
        self.phi_x_fc1 = nn.Linear(2 * d + e_in, d)
        self.phi_x_fc2 = nn.Linear(d, d)
        self.phi_x_fc3 = nn.Linear(d, 1)
        self.norm_layer = _layer_norm(d) if norm else None

    def forward(self, coords, inv_feats, adj_matrix, atom_mask, edge_feats, rep=None,
                dtype: torch.dtype = torch.float32):
        if rep is not None and self.rep_cond is not None:
            inv_feats = self.rep_cond(inv_feats, rep, atom_mask, dtype)
        sqrd, diff = _sqrd_dists(coords)
        e_in = torch.cat([edge_feats, sqrd.to(dtype)], dim=-1)
        m = F.silu(_factored_fc1(self.phi_e_fc1, inv_feats, e_in, dtype))
        m = F.silu(dense(m, self.phi_e_fc2, dtype))
        edge_pred = m[..., self.d_model:] if self.d_pred_edge else None
        m = m[..., :self.d_model]
        att = torch.sigmoid(dense(m, self.phi_att, dtype))
        m = m * att * adj_matrix[..., None]

        h = dense(_cat([inv_feats, m.sum(dim=2)]), self.phi_h_fc1, dtype)
        h = dense(F.silu(h), self.phi_h_fc2, dtype)

        # scalar coordinate update along the normalised differences
        s = F.silu(_factored_fc1(self.phi_x_fc1, inv_feats, e_in, dtype))
        s = F.silu(dense(s, self.phi_x_fc2, dtype))
        s = dense(s, self.phi_x_fc3, dtype)
        norm_diff = diff / (torch.sqrt(sqrd + 1e-8) + 1.0)
        upd = torch.sum(norm_diff * s.to(norm_diff.dtype) * adj_matrix[..., None], dim=2)
        coords = (coords + upd) * atom_mask[..., None]

        h = h * atom_mask[..., None]
        if self.norm_layer is not None:
            h = layer_norm(h, self.norm_layer, dtype)
        return coords, h, edge_pred


def _init_linears(module: nn.Module, generator):
    """flax's default Dense initialisation: lecun-normal weights (a normal
    truncated at 2 sigma, scaled to variance 1 / fan_in) and zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class _AltGenerator(nn.Module):
    """The input projections both generators share."""

    def __init__(self, d_model: int, vocab_size: int, n_atom_feats: int, d_edge: int,
                 n_edge_types: int, n_charge_types: int, self_cond: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.self_cond, self.compute_dtype = self_cond, compute_dtype
        self.feat_proj = nn.Linear(n_atom_feats + (vocab_size if self_cond else 0), d_model)
        self.edge_proj = nn.Linear(n_edge_types * (2 if self_cond else 1), d_edge)
        self.atom_head = nn.Linear(d_model, vocab_size)
        self.charge_head = nn.Linear(d_model, n_charge_types)

    def _inputs(self, coords, inv_feats, edge_feats, cond_atomics, cond_bonds, atom_mask):
        b, n, _ = coords.shape
        if atom_mask is None:
            atom_mask = torch.ones((b, n), dtype=coords.dtype, device=coords.device)
        dt = self.compute_dtype
        feats = [inv_feats.to(dt)]
        if cond_atomics is not None and self.self_cond:
            feats.append(cond_atomics.to(dt))
        h = dense(torch.cat(feats, dim=-1), self.feat_proj, dt)
        e = edge_feats.to(dt)
        if cond_bonds is not None and self.self_cond:
            e = torch.cat([e, cond_bonds.to(dt)], dim=-1)
        return atom_mask, adj_from_node_mask(atom_mask), h, dense(e, self.edge_proj, dt)

    def _heads(self, h):
        dt = self.compute_dtype
        return (dense(h, self.atom_head, dt).float(),
                dense(h, self.charge_head, dt).float())


class VanillaEgnnGenerator(_AltGenerator):
    """Reference: semlaflow/flowmodels/egnn.py:270-386. Every layer reads the
    projected input edges; the last one predicts the bond logits
    (symmetrised). With self-conditioning the input coordinates enter the
    stack twice, through reed_tpu's `x + cond_coord_gate(1) * 0 + coords`
    (the gate is in the parameter tree and gets a zero gradient)."""

    def __init__(self, d_model: int, vocab_size: int, n_atom_feats: int, d_edge: int = 16,
                 n_edge_types: int = 5, n_charge_types: int = 7, n_layers: int = 6,
                 self_cond: bool = False, d_rep: Optional[int] = None,
                 rep_alignment: bool = False, align_depth: Sequence[int] = (3,),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, vocab_size, n_atom_feats, d_edge, n_edge_types,
                         n_charge_types, self_cond, compute_dtype)
        self.cond_coord_gate = nn.Linear(1, 1, bias=False) if self_cond else None
        self.layers = nn.ModuleList(
            VanillaEgnnLayer(d_model, d_edge, n_edge_types if i == n_layers - 1 else None,
                             norm=True, d_rep=d_rep)
            for i in range(n_layers))
        self.align_layers = ([i for i in range(n_layers) if i in tuple(align_depth)]
                             if rep_alignment else [])
        self.projectors = nn.ModuleList(ProjectorMLP(d_model, d_model, d_rep)
                                        for _ in self.align_layers)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's initialisation: lecun-normal linears with zero biases,
        the coordinate head phi_x_fc3 from variance_scaling(1e-6, fan_avg,
        uniform), xavier-uniform projectors, unit LayerNorms."""
        _init_linears(self, generator)
        for layer in self.layers:
            w = layer.phi_x_fc3.weight
            limit = math.sqrt(3 * 1e-6 / ((w.shape[0] + w.shape[1]) / 2))
            nn.init.uniform_(w, -limit, limit, generator=generator)
        for proj in self.projectors:
            for m in proj:
                if isinstance(m, nn.Linear):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
        return self

    def forward(self, coords, inv_feats, edge_feats=None, cond_coords=None,
                cond_atomics=None, cond_bonds=None, atom_mask=None, rep=None, times=None):
        dt = self.compute_dtype
        atom_mask, adj, h, e = self._inputs(coords, inv_feats, edge_feats, cond_atomics,
                                            cond_bonds, atom_mask)
        x = coords
        if cond_coords is not None and self.self_cond:
            gate = dense(torch.ones(coords.shape[:2] + (1,), dtype=dt, device=coords.device),
                         self.cond_coord_gate, dt)
            x = x + gate * 0 + coords
        zs, edge_pred = [], None
        for i, layer in enumerate(self.layers):
            x, h, edge_pred = layer(x, h, adj, atom_mask, e, rep=rep, dtype=dt)
            if i in self.align_layers:
                proj = self.projectors[self.align_layers.index(i)]
                zs.append(proj(torch.sum(h.float(), dim=1)))
        type_logits, charge_logits = self._heads(h)
        bond_logits = (edge_pred + edge_pred.transpose(1, 2)).float()
        return zero_com(x.float(), atom_mask), type_logits, bond_logits, charge_logits, zs


class EqgatLayer(nn.Module):
    """Gated equivariant layer over invariant features and V vector channels
    a node (reference: semlaflow/flowmodels/eqgat.py:25-205)."""

    def __init__(self, d_model: int, d_edge: int, n_equi_feats: int,
                 d_rep: Optional[int] = None):
        super().__init__()
        d, v = d_model, n_equi_feats
        self.d_model, self.n_equi_feats = d_model, n_equi_feats
        self.rep_cond = (RepConditioner("cross_attn", d_model, d_rep)
                         if d_rep is not None else None)
        self.msg_fc1 = nn.Linear(2 * d + 1 + d_edge, d)
        self.msg_fc2 = nn.Linear(d, d + 2 * v)
        self.att = nn.Linear(d + 2 * v, 1)
        self.node_fc = nn.Linear(2 * d, d)
        self.gate_fc = nn.Linear(d + v, v)
        self.norm = _layer_norm(d)

    def forward(self, coords, inv_feats, equi_feats, adj_matrix, atom_mask, edge_feats,
                rep=None, dtype: torch.dtype = torch.float32):
        """equi_feats [B, N, V, 3]; returns (h, equi)."""
        d, v = self.d_model, self.n_equi_feats
        if rep is not None and self.rep_cond is not None:
            inv_feats = self.rep_cond(inv_feats, rep, atom_mask, dtype)
        sqrd, diff = _sqrd_dists(coords)
        norm_diff = diff / (torch.sqrt(sqrd + 1e-8) + 1.0)
        e_in = torch.cat([sqrd.to(dtype), edge_feats], dim=-1)
        m = F.silu(_factored_fc1(self.msg_fc1, inv_feats, e_in, dtype))
        m = dense(m, self.msg_fc2, dtype)
        att = torch.sigmoid(dense(m, self.att, dtype))
        m = m * att * adj_matrix[..., None]
        inv_msg, vec_gate, dir_gate = m[..., :d], m[..., d:d + v], m[..., d + v:]

        h = inv_feats + dense(F.silu(_cat([inv_feats, inv_msg.sum(dim=2)])), self.node_fc,
                              dtype)
        # gated neighbour vectors and gated directions
        nbr_vecs = torch.einsum("bijv,bjvd->bivd", vec_gate.to(equi_feats.dtype), equi_feats)
        dir_vecs = torch.einsum("bijv,bijd->bivd", dir_gate.to(norm_diff.dtype), norm_diff)
        equi = equi_feats + nbr_vecs + dir_vecs
        # gated self-interaction (GatedEquiUpdate, eqgat.py:25-62)
        lengths = torch.sqrt(torch.sum(equi ** 2, dim=-1) + 1e-8)            # [B,N,V]
        gates = dense(_cat([h, lengths.to(dtype)]), self.gate_fc, dtype)
        equi = equi * torch.sigmoid(gates)[..., None].to(equi.dtype)

        h = layer_norm(h, self.norm, dtype) * atom_mask[..., None]
        return h, equi * atom_mask[..., None, None]


class EqgatGenerator(_AltGenerator):
    """Reference: semlaflow/flowmodels/eqgat.py:325-423. The layers read the
    input coordinates; the coordinates come out of a linear combination of
    the vector channels, the bonds from a factored pair MLP over h_i + h_j
    and the projected edges. No alignment projectors (zs = [])."""

    def __init__(self, d_model: int, vocab_size: int, n_atom_feats: int, d_edge: int = 16,
                 n_edge_types: int = 5, n_charge_types: int = 7, n_layers: int = 6,
                 n_equi_feats: int = 16, self_cond: bool = False, d_rep: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(d_model, vocab_size, n_atom_feats, d_edge, n_edge_types,
                         n_charge_types, self_cond, compute_dtype)
        self.n_equi_feats = n_equi_feats
        self.layers = nn.ModuleList(EqgatLayer(d_model, d_edge, n_equi_feats, d_rep=d_rep)
                                    for _ in range(n_layers))
        self.coord_head = nn.Linear(n_equi_feats, 1, bias=False)
        self.bond_fc1 = nn.Linear(d_model + d_edge, d_edge)
        self.bond_fc2 = nn.Linear(d_edge, n_edge_types)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's initialisation: lecun-normal linears with zero biases,
        unit LayerNorms."""
        _init_linears(self, generator)
        return self

    def forward(self, coords, inv_feats, edge_feats=None, cond_coords=None,
                cond_atomics=None, cond_bonds=None, atom_mask=None, rep=None, times=None):
        dt = self.compute_dtype
        atom_mask, adj, h, e = self._inputs(coords, inv_feats, edge_feats, cond_atomics,
                                            cond_bonds, atom_mask)
        b, n, _ = coords.shape
        equi = torch.zeros((b, n, self.n_equi_feats, 3), dtype=coords.dtype,
                           device=coords.device)
        for layer in self.layers:
            h, equi = layer(coords, h, equi, adj, atom_mask, e, rep=rep, dtype=dt)
        coord_upd = dense(equi.transpose(-1, -2), self.coord_head, dt)[..., 0]
        pred_coords = zero_com((coords + coord_upd).float(), atom_mask)
        type_logits, charge_logits = self._heads(h)
        # bond_fc1 over concat([h_i + h_j, e]): one weight slice for both nodes
        dh = h.shape[-1]
        w, bias = self.bond_fc1.weight.to(dt), self.bond_fc1.bias.to(dt)
        hw = _pmm(h, w[:, :dh].T)
        pair = F.silu(hw[:, :, None] + hw[:, None, :] + e @ w[:, dh:].T + bias)
        bond_logits = dense(pair, self.bond_fc2, dt).float()
        return pred_coords, type_logits, bond_logits, charge_logits, []
