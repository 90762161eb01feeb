"""SE(3) flow model: an Invariant Point Attention trunk with backbone rigid
updates and a sequence (aatype) head, the MultiFlow codesign network.
Counterpart of reed_tpu/models/ipa.py (reference:
protein/multiflow/models/{flow_model.py, ipa_pytorch.py,
node_feature_net.py, edge_feature_net.py}).

Parameters carry the reference torch FlowModel's names and layouts
(`node_feature_net.linear.{0,2,4,5}`, `edge_feature_net.edge_embedder.*`,
`trunk.ipa_{b}.*`, `trunk.seq_tfmr_{b}.layers.{l}.self_attn.in_proj_weight`,
`trunk.edge_transition_{b}.trunk.{0,2}`, `aatype_pred_net.{0,2,4}`, ...),
so a reference checkpoint's state_dict loads unchanged. In particular
linear_q_points and linear_kv_points emit xyz as three H*P-wide column
blocks, and linear_out reads the point output as three such blocks, as
the reference does (reed_tpu interleaves them and permutes on conversion).
Rigids are (rotmats [..., 3, 3], trans [..., 3]) pairs.

Factored as reed_tpu: the IPA point logits use the gram identity
|q|^2 + |k|^2 - 2<q, k> (the [B,N,N,H,P,3] displacements are never built),
computed in f32 with the norms and the softmax; the edge embedder's first
layer acts on concat([node_i, node_j, pair feats, mask_i, mask_j]) through
the column blocks of its one weight, the node and mask parts as [B,N,.]
products before broadcasting. The sequence transformer is post-norm with
ReLU and FFN width d, attention through the plain `ops.attention.sdpa`
(reed_tpu's `sdpa_xla`, the finfo.min key mask) and no dropout.

With compute_dtype bfloat16 every Linear, LayerNorm and Embed computes as
flax's Dense/LayerNorm/Embed(dtype=bf16) does (nn/layers.py); the masks are
f32, so the same tensors as in JAX promote to f32. The backbone update,
the point attention's cross term and norms, and the softmax stay f32, and
the outputs are cast to f32.

Tensor parallelism (FlowModel's `parallel`, a parallel.mesh.DataParallel
with tensor T above 1; parallel/mesh.ipa_tp_rules): a rank holds H / T of
each IPA's heads (its rows of linear_q, linear_kv and of each xyz block of
the point projections, and the matching input rows of linear_out, whose
f32 partials the tensor group sums once before the bias) and of each
sequence-transformer layer's heads and feed-forward columns (Megatron
pairs). The inputs of the split products enter through copy_to_tensor, so
their partial gradients are summed: the node embedding, the rigids (the
point projections apply them to the rank's heads alone), and the pair
bias [B,N,N,H], down_z's pair features and head_weights, which every rank
computes whole (linear_b, down_z and head_weights are replicated) and of
which it uses its heads.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import dense, layer_norm, row_dense, split_width, tensor_size
from reed_tpu_torch.ops.attention import sdpa
from reed_tpu_torch.ops.so3 import quat_to_rotmat
from reed_tpu_torch.parallel.collectives import copy_to_tensor

ANG_TO_NM = 0.1
NM_TO_ANG = 10.0
NUM_TOKENS = 21  # 20 amino acids + mask


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of the f32 sections: f32, or f64 for an f64
    model."""
    return torch.promote_types(dtype, torch.float32)


def compose_rigids(rot_a, trans_a, rot_b, trans_b):
    """(a o b): rot = Ra Rb, trans = Ra tb + ta."""
    return rot_a @ rot_b, torch.einsum("...ij,...j->...i", rot_a, trans_b) + trans_a


def rigid_apply(rot, trans, points):
    """The rigid applied to points [..., P, 3] (rot [..., 3, 3], trans [..., 3])."""
    return torch.einsum("...ij,...pj->...pi", rot, points) + trans[..., None, :]


def rigid_invert_apply(rot, trans, points):
    return torch.einsum("...ji,...pj->...pi", rot, points - trans[..., None, :])


def mf_time_embedding(t, dim: int, max_positions: int = 2056):
    """The reference's time embedding [sin | cos] of t [B] (multiflow
    models/utils.py:49-61, called with max_positions 2056)."""
    half = dim // 2
    t = t.float() * max_positions
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(max_positions) / (half - 1)))
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def mf_index_embedding(indices, dim: int, max_len: int = 2056):
    """The reference's index embedding [sin_all | cos_all] (multiflow
    models/utils.py:28-46)."""
    k = torch.arange(dim // 2, dtype=torch.float32, device=indices.device)
    args = indices.float()[..., None] * math.pi / (max_len ** (2.0 * k / dim))
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def mf_distogram(pos, min_bin: float = 1e-3, max_bin: float = 20.0, num_bins: int = 22):
    """The reference's distogram (multiflow models/utils.py:15-25):
    (d > lower) & (d < upper) a bin, the last bin open-ended."""
    d = torch.linalg.vector_norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)[..., None]
    lower = torch.linspace(min_bin, max_bin, num_bins, device=pos.device)
    upper = torch.cat([lower[1:], torch.full((1,), 1e8, device=pos.device)])
    return ((d > lower) & (d < upper)).float()


class InvariantPointAttention(nn.Module):
    """AF2-style IPA with the pair output through down_z (reference:
    ipa_pytorch.py:236-477). Under the tensor axis of `parallel` it holds
    its rank's heads (the module docstring)."""

    def __init__(self, c_s: int = 256, c_z: int = 128, c_hidden: int = 16, no_heads: int = 8,
                 no_qk_points: int = 8, no_v_points: int = 12, parallel=None):
        super().__init__()
        self.c_hidden, self.no_heads = c_hidden, no_heads
        self.no_qk_points, self.no_v_points = no_qk_points, no_v_points
        self.parallel = parallel
        self.dtype = torch.float32
        h = split_width(no_heads, tensor_size(parallel), "the IPA")
        self.local_heads = h
        hc = c_hidden * h
        self.linear_q = nn.Linear(c_s, hc)
        self.linear_kv = nn.Linear(c_s, 2 * hc)
        self.linear_q_points = nn.Linear(c_s, h * no_qk_points * 3)
        self.linear_kv_points = nn.Linear(c_s, h * (no_qk_points + no_v_points) * 3)
        self.linear_b = nn.Linear(c_z, no_heads)
        self.down_z = nn.Linear(c_z, c_z // 4)
        self.head_weights = nn.Parameter(torch.zeros(no_heads))
        self.linear_out = nn.Linear(h * (c_z // 4 + c_hidden + no_v_points * 4), c_s)

    @staticmethod
    def _points(x, n_points):
        """[..., 3 * n_points] in xyz blocks -> [..., n_points, 3]."""
        return torch.stack(x.split(n_points, dim=-1), dim=-1)

    def forward(self, s, z, rot, trans, mask):
        """s [B,N,c_s], z [B,N,N,c_z], rigids in nm, mask [B,N]."""
        h, c, pq, pv = self.local_heads, self.c_hidden, self.no_qk_points, self.no_v_points
        dt, acc, parallel = self.dtype, _acc(self.dtype), self.parallel
        b, n, _ = s.shape
        s = copy_to_tensor(s, parallel)
        rot, trans = copy_to_tensor(rot, parallel), copy_to_tensor(trans, parallel)
        heads = slice(0, h) if parallel is None else slice(parallel.tensor_index * h,
                                                           (parallel.tensor_index + 1) * h)
        q = dense(s, self.linear_q, dt).view(b, n, h, c)
        k, v = dense(s, self.linear_kv, dt).view(b, n, h, 2 * c).split(c, dim=-1)

        q_pts = self._points(dense(s, self.linear_q_points, dt), h * pq)
        q_pts = rigid_apply(rot, trans, q_pts.to(acc)).view(b, n, h, pq, 3)
        kv_pts = self._points(dense(s, self.linear_kv_points, dt), h * (pq + pv))
        kv_pts = rigid_apply(rot, trans, kv_pts.to(acc)).view(b, n, h, pq + pv, 3)
        k_pts, v_pts = kv_pts.split([pq, pv], dim=-2)

        bias = copy_to_tensor(dense(z, self.linear_b, dt), parallel)[..., heads]  # [B,N,N,h]
        att = torch.einsum("bihc,bjhc->bhij", q, k) * math.sqrt(1.0 / (3 * c))
        att = att + math.sqrt(1.0 / 3) * bias.permute(0, 3, 1, 2)

        # point logits by the gram identity sum_{p,d} (q - k)^2 = |q|^2 +
        # |k|^2 - 2 <q, k>, in f32 to absorb the cancellation
        qn = torch.sum(q_pts ** 2, dim=(-1, -2)).transpose(1, 2)  # [B,H,N]
        kn = torch.sum(k_pts ** 2, dim=(-1, -2)).transpose(1, 2)
        cross = torch.einsum("bihpd,bjhpd->bhij", q_pts, k_pts)
        pt_att = qn[..., :, None] + kn[..., None, :] - 2.0 * cross
        head_weights = copy_to_tensor(self.head_weights, parallel)[heads]
        gamma = F.softplus(head_weights.to(acc)) * math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
        att = att + (pt_att * gamma[None, :, None, None] * (-0.5)).to(att.dtype)

        # the square mask, as the reference (ipa_pytorch.py:409-415)
        square_mask = mask[:, None, :] * mask[:, :, None]
        att = att + ((square_mask - 1.0) * 1e5)[:, None, :, :]
        att = torch.softmax(att.to(acc), dim=-1).to(dt)  # [B,H,N,N]

        o = torch.einsum("bhij,bjhc->bihc", att, v).reshape(b, n, h * c)
        o_pt = torch.einsum("bhij,bjhpd->bihpd", att.to(acc), v_pts)
        o_pt = rigid_invert_apply(rot, trans, o_pt.reshape(b, n, h * pv, 3))
        o_pt_norm = torch.sqrt(torch.sum(o_pt ** 2, dim=-1) + 1e-8)
        pair_z = copy_to_tensor(dense(z, self.down_z, dt), parallel)
        o_pair = torch.einsum("bhij,bijz->bihz", att, pair_z).reshape(b, n, -1)
        out = torch.cat([o, *o_pt.unbind(-1), o_pt_norm, o_pair], dim=-1)
        return row_dense(out, self.linear_out, dt, parallel)


class StructureModuleTransition(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dtype = torch.float32
        self.linear_1 = nn.Linear(c, c)
        self.linear_2 = nn.Linear(c, c)
        self.linear_3 = nn.Linear(c, c)
        self.ln = nn.LayerNorm(c)

    def forward(self, s):
        dt = self.dtype
        h = F.relu(dense(s, self.linear_1, dt))
        h = F.relu(dense(h, self.linear_2, dt))
        return layer_norm(s + dense(h, self.linear_3, dt), self.ln, dt)


class BackboneUpdate(nn.Module):
    """c_s -> (quaternion-vector rotation update, translation update)
    (reference: ipa_pytorch.py:194-233)."""

    def __init__(self, c_s: int):
        super().__init__()
        self.dtype = torch.float32
        self.linear = nn.Linear(c_s, 6)

    def forward(self, s):
        return dense(s, self.linear, self.dtype)


def apply_backbone_update(rot, trans, update, mask):
    """Compose the rigids with a (b, c, d, tx, ty, tz) update where mask is
    set; in the rigids' dtype (f32)."""
    update = update.to(rot.dtype)
    bcd, t_upd = update[..., :3], update[..., 3:]
    quat = torch.cat([torch.ones_like(bcd[..., :1]), bcd], dim=-1)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    new_rot, new_trans = compose_rigids(rot, trans, quat_to_rotmat(quat), t_upd)
    m = mask[..., None].bool()
    return torch.where(m[..., None], new_rot, rot), torch.where(m, new_trans, trans)


class EdgeTransition(nn.Module):
    """The edge update from the node embeddings (reference:
    ipa_pytorch.py:571-608): the dilated node embeddings cross-concatenated
    onto the edge embedding, a residual two-layer ReLU trunk at the concat
    width, a final projection and LayerNorm."""

    def __init__(self, node_embed_size: int, edge_embed_in: int, edge_embed_out: int,
                 node_dilation: int = 2):
        super().__init__()
        self.dtype = torch.float32
        bias_embed = node_embed_size // node_dilation
        hidden = 2 * bias_embed + edge_embed_in
        self.initial_embed = nn.Linear(node_embed_size, bias_embed)
        self.trunk = nn.Sequential(nn.Linear(hidden, hidden), nn.ReLU(),
                                   nn.Linear(hidden, hidden), nn.ReLU())
        self.final_layer = nn.Linear(hidden, edge_embed_out)
        self.layer_norm = nn.LayerNorm(edge_embed_out)

    def forward(self, node_embed, edge_embed):
        dt = self.dtype
        b, n, _ = node_embed.shape
        bias = dense(node_embed, self.initial_embed, dt)
        edge_bias = torch.cat([bias[:, :, None].expand(b, n, n, -1),
                               bias[:, None, :].expand(b, n, n, -1)], dim=-1)
        x = torch.cat([edge_embed, edge_bias], dim=-1)
        h = F.relu(dense(x, self.trunk[0], dt))
        h = F.relu(dense(h, self.trunk[2], dt))
        return layer_norm(dense(h + x, self.final_layer, dt), self.layer_norm, dt)


class NodeFeatureNet(nn.Module):
    """Residue index, diffuse mask, the three times, the aatype embedding and
    the self-conditioning logits -> node embedding (reference:
    node_feature_net.py, pdb_codesign config: use_mlp, embed_aatype)."""

    def __init__(self, c_s: int = 256, c_pos_emb: int = 128, c_timestep_emb: int = 128,
                 num_tokens: int = NUM_TOKENS):
        super().__init__()
        self.dtype = torch.float32
        self.c_pos_emb, self.c_timestep_emb, self.num_tokens = c_pos_emb, c_timestep_emb, num_tokens
        embed_size = c_pos_emb + 1 + 3 * c_timestep_emb + c_s + num_tokens
        self.aatype_embedding = nn.Embedding(21, c_s)
        self.linear = nn.Sequential(
            nn.Linear(embed_size, c_s), nn.ReLU(), nn.Linear(c_s, c_s), nn.ReLU(),
            nn.Linear(c_s, c_s), nn.LayerNorm(c_s))

    def forward(self, so3_t, r3_t, cat_t, res_mask, diffuse_mask, pos, aatypes, aatypes_sc=None):
        dt = self.dtype
        b, n = res_mask.shape
        m = res_mask[..., None]

        def embed_t(t):
            e = mf_time_embedding(t.reshape(-1), self.c_timestep_emb).reshape(b, 1, -1)
            return e.expand(b, n, -1).to(dt) * m

        if aatypes_sc is None:
            aatypes_sc = torch.zeros((b, n, self.num_tokens), device=res_mask.device)
        feats = [mf_index_embedding(pos, self.c_pos_emb).to(dt) * m,
                 diffuse_mask[..., None].to(dt), embed_t(so3_t), embed_t(r3_t),
                 F.embedding(aatypes, self.aatype_embedding.weight.to(dt)),
                 embed_t(cat_t), aatypes_sc]
        x = torch.cat([f.to(dt) for f in feats], dim=-1)
        x = F.relu(dense(x, self.linear[0], dt))
        x = F.relu(dense(x, self.linear[2], dt))
        return layer_norm(dense(x, self.linear[4], dt), self.linear[5], dt)


class EdgeFeatureNet(nn.Module):
    """Pair features: the cross-concatenated node projections, the relative
    position embedding, distograms of trans_t and the self-conditioning
    trans, and the cross-concatenated diffuse mask (reference:
    edge_feature_net.py, embed_diffuse_mask)."""

    def __init__(self, c_s: int = 256, c_z: int = 128, feat_dim: int = 64, num_bins: int = 22):
        super().__init__()
        self.dtype = torch.float32
        self.feat_dim, self.num_bins = feat_dim, num_bins
        self.linear_s_p = nn.Linear(c_s, feat_dim)
        self.linear_relpos = nn.Linear(feat_dim, feat_dim)
        total = 3 * feat_dim + 2 * num_bins + 2
        self.edge_embedder = nn.Sequential(
            nn.Linear(total, c_z), nn.ReLU(), nn.Linear(c_z, c_z), nn.ReLU(),
            nn.Linear(c_z, c_z), nn.LayerNorm(c_z))

    def forward(self, node_embed, trans_t, trans_sc, edge_mask, diffuse_mask):
        dt, f = self.dtype, self.feat_dim
        b, n, _ = node_embed.shape
        p_i = dense(node_embed, self.linear_s_p, dt)
        # the reference uses arange, not res_idx (edge_feature_net.py:57-60);
        # the same for every row, so embedded once
        r = torch.arange(n, device=node_embed.device)
        relpos = dense(mf_index_embedding(r[:, None] - r[None, :], f).to(dt),
                       self.linear_relpos, dt)
        pair = torch.cat([relpos.expand(b, n, n, f),
                          mf_distogram(trans_t, num_bins=self.num_bins).to(dt),
                          mf_distogram(trans_sc, num_bins=self.num_bins).to(dt)], dim=-1)
        # the first layer over concat([p_i, p_j, pair, dm_i, dm_j]) through the
        # column blocks of its weight: the node and mask parts as [B,N,.]
        # products before broadcasting
        first = self.edge_embedder[0]
        w0, b0 = first.weight.to(dt).t(), first.bias.to(dt)
        p = pair.shape[-1]
        x = ((p_i @ w0[:f])[:, :, None, :] + (p_i @ w0[f:2 * f])[:, None, :, :]
             + pair @ w0[2 * f:2 * f + p] + b0)
        dm = diffuse_mask[..., None].to(dt)
        wd = w0[2 * f + p:]
        x = x + ((dm @ wd[:1])[:, :, None, :] + (dm @ wd[1:])[:, None, :, :])
        x = F.relu(x)
        x = F.relu(dense(x, self.edge_embedder[2], dt))
        x = layer_norm(dense(x, self.edge_embedder[4], dt), self.edge_embedder[5], dt)
        return x * edge_mask[..., None]


class _SelfAttention(nn.Module):
    """The parameters of torch's MultiheadAttention under its names: the
    packed [q; k; v] input projection and out_proj; `local` of the d
    channels of each of q, k and v (and of out_proj's input) where a tensor
    rank holds its heads."""

    def __init__(self, d: int, local: Optional[int] = None):
        super().__init__()
        local = d if local is None else local
        self.in_proj_weight = nn.Parameter(torch.empty(3 * local, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * local))
        self.out_proj = nn.Linear(local, d)


class SeqTransformerBlock(nn.Module):
    """One post-norm transformer layer under nn.TransformerEncoderLayer's
    parameter names: self-attention, ReLU FFN of width d, no dropout. Under
    the tensor axis of `parallel` it holds its rank's heads and FFN columns
    (two Megatron pairs, their f32 partials summed before the biases)."""

    def __init__(self, d: int, num_heads: int = 4, parallel=None):
        super().__init__()
        self.dtype = torch.float32
        self.parallel = parallel
        tensor = tensor_size(parallel)
        self.num_heads = split_width(num_heads, tensor, "the sequence attention")
        self.head_dim = d // num_heads
        local = split_width(d, tensor, "the sequence transformer's feed-forward")
        self.self_attn = _SelfAttention(d, self.num_heads * self.head_dim)
        self.linear1 = nn.Linear(d, local)
        self.linear2 = nn.Linear(local, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, mask):
        dt, heads, parallel = self.dtype, self.num_heads, self.parallel
        b, n, _ = x.shape
        attn = self.self_attn
        qkv = F.linear(copy_to_tensor(x.to(dt), parallel), attn.in_proj_weight.to(dt),
                       attn.in_proj_bias.to(dt))
        q, k, v = qkv.view(b, n, 3 * heads, self.head_dim).split(heads, dim=2)
        o = sdpa(q, k, v, mask=(mask[:, None, None, :] > 0)).reshape(b, n, -1)
        x = layer_norm(x + row_dense(o, attn.out_proj, dt, parallel), self.norm1, dt)
        h = F.relu(dense(copy_to_tensor(x, parallel), self.linear1, dt))
        return layer_norm(x + row_dense(h, self.linear2, dt, parallel), self.norm2, dt)


class SeqTransformer(nn.Module):
    """The layers of the reference's nn.TransformerEncoder (no final norm)."""

    def __init__(self, d: int, num_heads: int, num_layers: int, parallel=None):
        super().__init__()
        self.layers = nn.ModuleList(SeqTransformerBlock(d, num_heads, parallel)
                                    for _ in range(num_layers))

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class FlowModel(nn.Module):
    """The MultiFlow trunk (reference: flow_model.py:11-154). `parallel`
    splits the IPAs and sequence transformers over its tensor axis (the
    module docstring): the parameters are then a tensor rank's shards,
    whose names stay the whole model's (parallel/mesh.shard_state_dict)."""

    def __init__(self, c_s: int = 256, c_z: int = 128, num_blocks: int = 6,
                 ipa_c_hidden: int = 16, ipa_no_heads: int = 8, ipa_no_qk_points: int = 8,
                 ipa_no_v_points: int = 12, seq_tfmr_num_heads: int = 4,
                 seq_tfmr_num_layers: int = 2, aatype_pred_num_tokens: int = NUM_TOKENS,
                 compute_dtype: torch.dtype = torch.float32, parallel=None):
        super().__init__()
        self.num_blocks = num_blocks
        self.compute_dtype = compute_dtype
        self.node_feature_net = NodeFeatureNet(c_s)
        self.edge_feature_net = EdgeFeatureNet(c_s, c_z)
        self.trunk = nn.ModuleDict()
        for b in range(num_blocks):
            self.trunk[f"ipa_{b}"] = InvariantPointAttention(
                c_s, c_z, ipa_c_hidden, ipa_no_heads, ipa_no_qk_points, ipa_no_v_points,
                parallel)
            self.trunk[f"ipa_ln_{b}"] = nn.LayerNorm(c_s)
            self.trunk[f"seq_tfmr_{b}"] = SeqTransformer(c_s, seq_tfmr_num_heads,
                                                         seq_tfmr_num_layers, parallel)
            self.trunk[f"post_tfmr_{b}"] = nn.Linear(c_s, c_s)
            self.trunk[f"node_transition_{b}"] = StructureModuleTransition(c_s)
            self.trunk[f"bb_update_{b}"] = BackboneUpdate(c_s)
            if b < num_blocks - 1:
                self.trunk[f"edge_transition_{b}"] = EdgeTransition(c_s, c_z, c_z)
        self.aatype_pred_net = nn.Sequential(
            nn.Linear(c_s, c_s), nn.ReLU(), nn.Linear(c_s, c_s), nn.ReLU(),
            nn.Linear(c_s, aatype_pred_num_tokens))
        for m in self.modules():
            if hasattr(m, "dtype"):
                m.dtype = compute_dtype

    @torch.no_grad()
    def initialize_weights(self, generator=None):
        """reed_tpu's (flax's default) initialisation: lecun-normal linears (a
        normal truncated at 2 sigma, scaled to variance 1/fan_in) with zero
        biases, and zero weights for the layers reed_tpu starts at zero (IPA
        linear_out, the transitions' linear_3, the backbone updates,
        post_tfmr); zero IPA head weights, unit LayerNorms, an N(0, 1/c_s)
        aatype table, the packed attention projection lecun-normal as
        reed_tpu's qkv Dense."""
        zero = ("linear_out", "linear_3", "bb_update", "post_tfmr")
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if any(z in name for z in zero):
                    nn.init.zeros_(m.weight)
                else:
                    _lecun_normal(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, _SelfAttention):
                _lecun_normal(m.in_proj_weight, generator)
                nn.init.zeros_(m.in_proj_bias)
            elif isinstance(m, InvariantPointAttention):
                nn.init.zeros_(m.head_weights)
        emb = self.node_feature_net.aatype_embedding.weight
        nn.init.normal_(emb, std=emb.shape[1] ** -0.5, generator=generator)
        return self

    def forward(self, batch: Dict) -> Dict:
        """batch: res_mask, so3_t, r3_t, cat_t, trans_t (Angstrom), rotmats_t,
        aatypes_t, trans_sc, aatypes_sc, res_idx (and diffuse_mask). Returns
        pred_trans (Angstrom), pred_rotmats and pred_logits, in f32."""
        dt = self.compute_dtype
        mask = batch["res_mask"]
        edge_mask = mask[:, None, :] * mask[:, :, None]
        diffuse_mask = batch.get("diffuse_mask")
        if diffuse_mask is None:
            diffuse_mask = torch.ones_like(mask)
        trans_sc = batch.get("trans_sc")
        if trans_sc is None:
            trans_sc = torch.zeros_like(batch["trans_t"])
        node_embed = self.node_feature_net(
            batch["so3_t"], batch["r3_t"], batch["cat_t"], mask, diffuse_mask,
            batch["res_idx"], batch["aatypes_t"], batch.get("aatypes_sc"))
        edge_embed = self.edge_feature_net(node_embed, batch["trans_t"], trans_sc, edge_mask,
                                           diffuse_mask)
        rot = batch["rotmats_t"]
        trans = batch["trans_t"] * ANG_TO_NM
        node_embed = node_embed * mask[..., None]
        edge_embed = edge_embed * edge_mask[..., None]
        trunk = self.trunk
        for b in range(self.num_blocks):
            ipa_out = trunk[f"ipa_{b}"](node_embed, edge_embed, rot, trans, mask)
            node_embed = layer_norm(node_embed + ipa_out * mask[..., None],
                                    trunk[f"ipa_ln_{b}"], dt)
            h = trunk[f"seq_tfmr_{b}"](node_embed, mask)
            node_embed = node_embed + dense(h, trunk[f"post_tfmr_{b}"], dt)
            node_embed = trunk[f"node_transition_{b}"](node_embed)
            node_embed = node_embed * mask[..., None]
            update = trunk[f"bb_update_{b}"](node_embed)
            rot, trans = apply_backbone_update(rot, trans, update, mask * diffuse_mask)
            if b < self.num_blocks - 1:
                edge_embed = trunk[f"edge_transition_{b}"](node_embed, edge_embed)
                edge_embed = edge_embed * edge_mask[..., None]
        net = self.aatype_pred_net
        logits = F.relu(dense(node_embed, net[0], dt))
        logits = F.relu(dense(logits, net[2], dt))
        logits = dense(logits, net[4], dt)
        out = _acc(dt)
        return {"pred_trans": (trans * NM_TO_ANG).to(out), "pred_rotmats": rot.to(out),
                "pred_logits": logits.to(out)}


def _lecun_normal(weight, generator=None):
    """flax's lecun_normal on a torch [out, in] weight."""
    std = weight.shape[1] ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)
