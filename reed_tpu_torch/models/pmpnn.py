"""ProteinMPNN-FMIF (torch.nn): k-NN message-passing inverse folding with
REED's representation projectors.

Counterpart of reed_tpu/models/pmpnn.py with the reference's parameter
names (the names reed_tpu/encoders/fmif_convert.py reads): features.
{embeddings.linear, edge_embedding, norm_edges}, node_embeds, W_e, W_s,
encoder_layers.{i}.{W1,W2,W3,W11,W12,W13,norm1,norm2,norm3,dense},
decoder_layers.{i}.{W1,W2,W3,norm1,norm2,dense,W_edge.{0,1,3},norm_edge},
W_out, projectors_{single,pair,structure}.{0,2} and, with use_cfg,
cls_embedder and cls_layers_{enc,dec}.{i}.

Numerics pinned to reed_tpu's: erf GELU everywhere; every LayerNorm has eps
1e-5, f32 statistics and f32 parameters under bf16 (as flax keeps them);
logits are cast to f32 before the log-softmax; the projectors run in f32.
The first dense of each message MLP is factored through slices of its
weight, as reed_tpu does: the self part is a [B,L,D] product and the
neighbour part is gathered after its product. With `fused` the rest of
each chain (edge product, gather, two GELUs, W2, W3, mask, K-sum) is one
call of ops.fused_message.fused_message_mlp: the CUDA kernel on the card,
its plain version on the CPU. Neighbour gathers are indexed gathers, not
reed_tpu's one-hot einsums. With `train=True` the model applies dropout
at reed_tpu's six sites (EncLayer: the node update after the message sum
and after the feed-forward, and the edge message; DecLayer: the edge update,
and the node update twice), inverted as flax's Dropout (keep with
probability 1 - rate, scale by 1 / (1 - rate)), and Gaussian coordinate
noise of std augment_eps; both draw from an explicit torch.Generator.
`detach_repr` stops the projectors' gradients into the trunk, and
`learnable_node=False` stops node_embeds' gradient, as stop_gradient does.

`parallel` (a parallel.mesh.DataParallel) splits the model over its tensor
axis of T ranks (parallel/mesh.PMPNN_TP_RULES; the parameter names stay the
reference's, the shapes are a rank's shards, parallel/mesh.shard_state_dict):
each message chain's W2 (W12) by its output columns and W3 (W13) by its
input rows, so that a rank runs the whole first product and H = D / T of
the hidden units (ops.fused_message_mlp's `parallel` on the fused path;
copy_to_tensor at W2's input and a row-parallel W3 on the unfused one), and
Megatron's column/row pair on each feed-forward, the decoder's edge update
(W_edge.1 / W_edge.3) and the projectors (.0 / .2, in f32). Every row-
parallel product sums its f32 partials over the tensor group and adds its
bias once; everything else is whole and computed alike on every rank,
dropout masks included (the ranks draw them from one generator state).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.data.protein import MASK_TOKEN_INDEX, NUM_TOKENS
from reed_tpu_torch.nn.layers import linear, row_parallel, split_width
from reed_tpu_torch.ops.fused_message import fused_message_mlp
from reed_tpu_torch.ops.graph import gather_nodes, knn_graph, rbf
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.collectives import copy_to_tensor

NEG_INF = -1e6

# 25 ordered atom pairs (reference order); the first, Ca-Ca, is the k-NN
# distance itself
_PAIRS = [("Ca", "Ca"), ("N", "N"), ("C", "C"), ("O", "O"), ("Cb", "Cb"),
          ("Ca", "N"), ("Ca", "C"), ("Ca", "O"), ("Ca", "Cb"), ("N", "C"),
          ("N", "O"), ("N", "Cb"), ("Cb", "C"), ("Cb", "O"), ("O", "C"),
          ("N", "Ca"), ("C", "Ca"), ("O", "Ca"), ("Cb", "Ca"), ("C", "N"),
          ("O", "N"), ("Cb", "N"), ("C", "Cb"), ("O", "Cb"), ("C", "O")]
_ATOMS = ("N", "Ca", "C", "O", "Cb")


def gelu(x):
    return F.gelu(x, approximate="none")


class Dropout:
    """flax.linen.Dropout's inverted dropout with its keep mask drawn from a
    torch.Generator: x * (u < 1 - rate) / (1 - rate), u ~ U[0, 1). Identity
    when `active` is False or the rate is 0."""

    def __init__(self, rate: float, active: bool = False,
                 generator: Optional[torch.Generator] = None):
        self.rate, self.active, self.generator = rate, active, generator

    def __call__(self, x):
        if not self.active or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = draws.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


NO_DROPOUT = Dropout(0.0)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics and affine, output in the input dtype
    (flax's LayerNorm under a bf16 compute dtype)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def column_row(x, fc1: nn.Linear, fc2: nn.Linear, act, parallel):
    """fc2(act(fc1(x))) with fc1 holding this rank's output columns and fc2
    its input rows (Megatron's pair): x enters through copy_to_tensor, the
    f32 partials are summed over the tensor group and fc2's bias is added
    once (nn/layers.row_parallel)."""
    h = act(linear(copy_to_tensor(x, parallel), fc1))
    return row_parallel(h, fc2, parallel)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, dim: int, num_ff: int, tensor: int = 1):
        super().__init__()
        self.tensor = tensor
        self.W_in = nn.Linear(dim, split_width(num_ff, tensor, "the feed-forward"))
        self.W_out = nn.Linear(num_ff // tensor, dim)

    def forward(self, x, parallel=None):
        if self.tensor == 1:
            return self.W_out(gelu(self.W_in(x)))
        return column_row(x, self.W_in, self.W_out, gelu, parallel)


class PositionalEncodings(nn.Module):
    """Relative-position edge embedding with a chain-break code. The one-hot
    product of reed_tpu is a column lookup of the weight plus the bias."""

    def __init__(self, num_embeddings: int, max_relative_feature: int = 32):
        super().__init__()
        self.max_relative_feature = max_relative_feature
        self.linear = nn.Linear(2 * max_relative_feature + 2, num_embeddings)

    @staticmethod
    def code(offset, same_chain, max_relative_feature: int = 32):
        m = max_relative_feature
        return (torch.clamp(offset + m, 0, 2 * m) * same_chain
                + (1 - same_chain) * (2 * m + 1))

    def forward(self, code):
        return F.embedding(code, self.linear.weight.t()) + self.linear.bias


class ProteinFeatures(nn.Module):
    """Backbone geometry -> edge features over a masked k-NN graph."""

    def __init__(self, edge_features: int, top_k: int = 30, num_rbf: int = 16,
                 num_positional_embeddings: int = 16):
        super().__init__()
        self.top_k = top_k
        self.num_rbf = num_rbf
        self.embeddings = PositionalEncodings(num_positional_embeddings)
        self.edge_embedding = nn.Linear(
            num_positional_embeddings + len(_PAIRS) * num_rbf, edge_features,
            bias=False)
        self.norm_edges = LayerNorm(edge_features)

    def forward(self, x, mask, residue_idx, chain_labels, augment_eps: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """x [B,L,4,3] backbone atoms (N, Ca, C, O), plus augment_eps * N(0, 1)
        noise from `generator` when augment_eps > 0. Returns edge features
        [B,L,K,E] and neighbour indices [B,L,K] int32."""
        x = x.float()
        if augment_eps > 0:
            x = x + augment_eps * draws.randn(x.shape, generator=generator, device=x.device)
        b_vec = x[:, :, 1] - x[:, :, 0]
        c_vec = x[:, :, 2] - x[:, :, 1]
        a_vec = torch.linalg.cross(b_vec, c_vec, dim=-1)
        # virtual C-beta from ideal tetrahedral geometry
        cb = -0.58273431 * a_vec + 0.56802827 * b_vec - 0.54067466 * c_vec + x[:, :, 1]
        atoms = dict(zip(_ATOMS[:4], x.unbind(2)), Cb=cb)

        d_neighbors, e_idx = knn_graph(atoms["Ca"], mask.float(), self.top_k)
        stacked = torch.stack([atoms[a] for a in _ATOMS], dim=2)  # [B,L,5,3]
        b, l, k = e_idx.shape
        nbr = gather_nodes(stacked.reshape(b, l, -1), e_idx).reshape(b, l, k, 5, 3)
        nbr_atoms = {a: nbr[..., i, :] for i, a in enumerate(_ATOMS)}
        rbf_all = [rbf(d_neighbors, self.num_rbf)]
        for a_name, b_name in _PAIRS[1:]:
            diff = atoms[a_name][:, :, None, :] - nbr_atoms[b_name]
            d = torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-6)
            rbf_all.append(rbf(d, self.num_rbf))
        rbf_all = torch.cat(rbf_all, dim=-1)  # [B,L,K,25*num_rbf]

        offset = residue_idx[:, :, None] - residue_idx[:, None, :]
        same_chain = (chain_labels[:, :, None] == chain_labels[:, None, :]).long()
        code = PositionalEncodings.code(offset.long(), same_chain)
        code = torch.gather(code, 2, e_idx.long())
        dtype = self.edge_embedding.weight.dtype
        e = torch.cat([self.embeddings(code), rbf_all.to(dtype)], dim=-1)
        return self.norm_edges(self.edge_embedding(e)), e_idx


def _factored_first_dense(w1: nn.Linear, h_v, e_slice: slice, nbr_start: int):
    """The first dense over concat([h_v_i, e_ik, h_v_j]) split by weight
    slices: (self part + bias [B,L,D], edge weight [Ce,D] in flax layout,
    neighbour source [B,L,D] to be gathered)."""
    d = h_v.shape[-1]
    w = w1.weight  # [D, in]
    pre_self = F.linear(h_v, w[:, :d], w1.bias)
    nbr_src = F.linear(h_v, w[:, nbr_start:])
    return pre_self, w[:, e_slice].t(), nbr_src


def _fused_chain(w1, w2, w3, h_v, e_feat, e_idx, e_slice, nbr_start, mask,
                 mask_mode, scale, want_sum, want_msg, parallel=None):
    pre_self, w_e, nbr_src = _factored_first_dense(w1, h_v, e_slice, nbr_start)
    return fused_message_mlp(pre_self, e_feat, nbr_src, e_idx, w_e,
                             w2.weight.t(), w2.bias, w3.weight.t(), w3.bias,
                             mask=mask, mask_mode=mask_mode, scale=scale,
                             want_sum=want_sum, want_msg=want_msg, parallel=parallel)


def _chain_tail(w2, w3, pre, tensor, parallel):
    """The unfused chain after the first product: W3(gelu(W2(gelu(pre)))),
    split over the hidden units under the tensor axis (m1 enters W2's
    column shard through copy_to_tensor, W3's row shard sums its f32
    partials over the group and adds b3 once)."""
    if tensor == 1:
        return w3(gelu(w2(gelu(pre))))
    return column_row(gelu(pre), w2, w3, gelu, parallel)


class EncLayer(nn.Module):
    """Node + edge message-passing encoder layer (`tensor`: the ranks its
    message chains and feed-forward are split over)."""

    def __init__(self, dim: int, scale: float = 30.0, tensor: int = 1):
        super().__init__()
        self.scale = scale
        self.tensor = tensor
        hidden = split_width(dim, tensor, "a message chain")
        for name in ("W1", "W11"):
            setattr(self, name, nn.Linear(3 * dim, dim))
        # W2 (W12) keeps its hidden units' output columns, W3 (W13) their input
        # rows; registered in the reference's order (the initialisation's)
        for name in ("W2", "W3", "W12", "W13"):
            setattr(self, name, nn.Linear(dim, hidden) if name in ("W2", "W12")
                    else nn.Linear(hidden, dim))
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim) for _ in range(3))
        self.dense = PositionWiseFeedForward(dim, 4 * dim, tensor)

    def _message(self, w1, w2, w3, h_v, h_e, e_idx, parallel):
        d = h_v.shape[-1]
        pre_self, w_e, nbr_src = _factored_first_dense(w1, h_v, slice(d, 2 * d), 2 * d)
        pre = pre_self[:, :, None, :] + h_e @ w_e + gather_nodes(nbr_src, e_idx)
        return _chain_tail(w2, w3, pre, self.tensor, parallel)

    def forward(self, h_v, h_e, e_idx, mask_v, mask_attend, fused: bool,
                drop: Dropout = NO_DROPOUT, parallel=None):
        d = h_v.shape[-1]
        e_slice = slice(d, 2 * d)
        if fused:
            dh, _ = _fused_chain(self.W1, self.W2, self.W3, h_v, h_e, e_idx,
                                 e_slice, 2 * d, mask_attend, "post", self.scale,
                                 True, False, parallel)
        else:
            h_message = self._message(self.W1, self.W2, self.W3, h_v, h_e, e_idx, parallel)
            h_message = mask_attend[..., None] * h_message
            dh = torch.sum(h_message, dim=-2) / self.scale
        h_v = self.norm1(h_v + drop(dh))
        h_v = self.norm2(h_v + drop(self.dense(h_v, parallel)))
        h_v = mask_v[..., None] * h_v

        if fused:
            _, h_message = _fused_chain(self.W11, self.W12, self.W13, h_v, h_e,
                                        e_idx, e_slice, 2 * d, None, "none",
                                        self.scale, False, True, parallel)
        else:
            h_message = self._message(self.W11, self.W12, self.W13, h_v, h_e, e_idx,
                                      parallel)
        return h_v, self.norm3(h_e + drop(h_message))


class DecLayer(nn.Module):
    """Decoder layer with REED's edge-update head (`tensor`: the ranks its
    message chain, feed-forward and edge update are split over)."""

    def __init__(self, dim: int, scale: float = 30.0, tensor: int = 1):
        super().__init__()
        self.scale = scale
        self.tensor = tensor
        hidden = split_width(dim, tensor, "a message chain")
        self.W1 = nn.Linear(4 * dim, dim)
        self.W2 = nn.Linear(dim, hidden)
        self.W3 = nn.Linear(hidden, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.dense = PositionWiseFeedForward(dim, 4 * dim, tensor)
        edge_hidden = split_width(3 * dim, tensor, "the edge update")
        self.W_edge = nn.Sequential(LayerNorm(3 * dim), nn.Linear(3 * dim, edge_hidden),
                                    nn.GELU(approximate="none"),
                                    nn.Linear(edge_hidden, 2 * dim))
        self.norm_edge = LayerNorm(2 * dim)

    def _edge_update(self, x, parallel):
        if self.tensor == 1:
            return self.W_edge(x)
        norm, fc1, _, fc2 = self.W_edge
        return column_row(norm(x), fc1, fc2, gelu, parallel)

    def forward(self, h_v, h_es, e_idx, mask_v, fused: bool, drop: Dropout = NO_DROPOUT,
                parallel=None):
        """mask_v [B,L]: each edge of node i is masked by i's own mask (not
        its neighbour's), before the self term is added."""
        d = h_v.shape[-1]
        e_slice = slice(d, 3 * d)
        if fused:
            mask_k = mask_v[:, :, None].expand(e_idx.shape)
            dh, h_message = _fused_chain(self.W1, self.W2, self.W3, h_v, h_es,
                                         e_idx, e_slice, 3 * d, mask_k, "pre",
                                         self.scale, True, True, parallel)
        else:
            pre_self, w_e, nbr_src = _factored_first_dense(self.W1, h_v, e_slice, 3 * d)
            edge_terms = h_es @ w_e + gather_nodes(nbr_src, e_idx)
            edge_terms = mask_v[:, :, None, None] * edge_terms
            h_message = _chain_tail(self.W2, self.W3, pre_self[:, :, None, :] + edge_terms,
                                    self.tensor, parallel)
            dh = torch.sum(h_message, dim=-2) / self.scale

        # edge update: h_ES <- LN(h_ES + MLP([h_message, h_ES]))
        de = self._edge_update(torch.cat([h_message, h_es], dim=-1), parallel)
        h_es_new = self.norm_edge(h_es + drop(de))

        h_v = self.norm1(h_v + drop(dh))
        h_v = self.norm2(h_v + drop(self.dense(h_v, parallel)))
        return mask_v[..., None] * h_v, h_es_new


def projector(in_dim: int, projector_dim: int, z_dim: int, tensor: int = 1) -> nn.Sequential:
    """2-layer SiLU projector (keys 0 and 2, as the reference's build_mlp);
    under the tensor axis a rank's column/row shards of its hidden units."""
    hidden = split_width(projector_dim, tensor, "a projector")
    return nn.Sequential(nn.Linear(in_dim, hidden), nn.SiLU(), nn.Linear(hidden, z_dim))


class ProteinMPNNFMIF(nn.Module):
    def __init__(self, hidden_dim: int = 128, edge_features: int = 128,
                 num_encoder_layers: int = 3, num_decoder_layers: int = 3,
                 vocab: int = NUM_TOKENS, k_neighbors: int = 30,
                 use_cfg: bool = False, num_cls: int = 2, update_edge: bool = True,
                 align_depth: int = 1, single_dim: int = 384, pair_dim: int = 128,
                 structure_dim: int = 768, mdlm_parameterization: bool = False,
                 fused: bool = False, dropout: float = 0.1, augment_eps: float = 0.1,
                 learnable_node: bool = True, parallel=None):
        super().__init__()
        # the mesh (a parallel.mesh.DataParallel) whose tensor axis splits the
        # model, or None
        self.parallel = parallel
        tensor = 1 if parallel is None else parallel.tensor
        self.tensor = tensor
        self.vocab = vocab
        self.use_cfg = use_cfg
        self.num_cls = num_cls
        self.update_edge = update_edge
        self.align_depth = align_depth
        self.mdlm_parameterization = mdlm_parameterization
        # training only (forward's `train`): dropout rate, coordinate noise std
        self.dropout = dropout
        self.augment_eps = augment_eps
        self.learnable_node = learnable_node
        # route the message chains through ops.fused_message (kernel on CUDA)
        self.fused = fused

        self.features = ProteinFeatures(edge_features, k_neighbors)
        self.node_embeds = nn.Parameter(torch.zeros(hidden_dim))
        self.W_e = nn.Linear(edge_features, hidden_dim)
        self.W_s = nn.Embedding(vocab, hidden_dim)
        self.encoder_layers = nn.ModuleList(
            EncLayer(hidden_dim, tensor=tensor) for _ in range(num_encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecLayer(hidden_dim, tensor=tensor) for _ in range(num_decoder_layers))
        self.W_out = nn.Linear(hidden_dim, vocab)
        if use_cfg:
            self.cls_embedder = nn.Embedding(num_cls + 1, hidden_dim)
            self.cls_layers_enc = nn.ModuleList(
                nn.Linear(hidden_dim, hidden_dim) for _ in range(num_encoder_layers))
            self.cls_layers_dec = nn.ModuleList(
                nn.Linear(hidden_dim, hidden_dim) for _ in range(num_decoder_layers))
        self.projectors_single = projector(hidden_dim, 2 * single_dim, single_dim, tensor)
        self.projectors_pair = projector(2 * hidden_dim, 2 * pair_dim, pair_dim, tensor)
        self.projectors_structure = projector(hidden_dim, 2 * structure_dim,
                                              structure_dim, tensor)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's initialisation: xavier-uniform dense kernels with zero
        biases, N(0, 0.02) W_s table, zero node_embeds, unit LayerNorms; the
        class layers take flax's defaults (N(0, 1/fan_in) kernels, zero
        biases; N(0, 1/hidden) class table)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.normal_(self.W_s.weight, std=0.02, generator=generator)
        nn.init.zeros_(self.node_embeds)
        if self.use_cfg:
            hidden = self.cls_embedder.weight.shape[1]
            nn.init.normal_(self.cls_embedder.weight, std=hidden ** -0.5,
                            generator=generator)
            for lin in (*self.cls_layers_enc, *self.cls_layers_dec):
                nn.init.normal_(lin.weight, std=lin.weight.shape[1] ** -0.5,
                                generator=generator)
        return self

    def to_compute_dtype(self, dtype: torch.dtype):
        """Compute in `dtype` (f32 or bf16) as reed_tpu's `dtype` does: every
        dense, embedding and node_embeds in `dtype`; LayerNorms and the
        projectors stay f32."""
        self.to(dtype)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.float()
        for p in (self.projectors_single, self.projectors_pair,
                  self.projectors_structure):
            p.float()
        return self

    def compute_params(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The parameters as to_compute_dtype(dtype) holds them, each cast
        from this model's (f32 master) parameter where it is used, so the
        cast's backward carries its gradient to the master; LayerNorms and
        the projectors keep theirs."""
        keep = tuple(f"{n}." for n, m in self.named_modules()
                     if isinstance(m, nn.LayerNorm) or n.startswith("projectors_"))
        return {n: p if n.startswith(keep) else p.to(dtype)
                for n, p in self.named_parameters()}

    def cast_forward(self, dtype: torch.dtype, *args, **kwargs):
        """forward computed in `dtype` over the f32 master parameters, as
        flax's Dense(dtype=...) computes over f32 params (reed_tpu's bf16
        training): the same math as to_compute_dtype(dtype)'s model, with
        gradients in f32 on the masters."""
        return torch.func.functional_call(self, self.compute_params(dtype), args, kwargs)

    @property
    def dtype(self) -> torch.dtype:
        return self.W_e.weight.dtype

    def encode(self, x, mask, residue_idx, chain_encoding_all, cls_emb=None,
               train: bool = False, generator: Optional[torch.Generator] = None,
               drop: Dropout = NO_DROPOUT):
        """Features and encoder stack: (h_v, h_e, e_idx). Depends only on the
        backbone (and the class), so a sampler computes it once."""
        e, e_idx = self.features(x, mask, residue_idx, chain_encoding_all,
                                 augment_eps=self.augment_eps if train else 0.0,
                                 generator=generator)
        mask = mask.to(e.dtype)
        node = self.node_embeds if self.learnable_node else self.node_embeds.detach()
        h_v = node.expand(*e.shape[:2], -1)
        h_e = self.W_e(e)
        mask_attend = mask[..., None] * gather_nodes(mask[..., None], e_idx)[..., 0]
        for i, layer in enumerate(self.encoder_layers):
            if cls_emb is not None:
                h_v = h_v + self.cls_layers_enc[i](cls_emb)[:, None, :]
            h_v, h_e = layer(h_v, h_e, e_idx, mask, mask_attend, fused=self.fused,
                             drop=drop, parallel=self.parallel)
        return h_v, h_e, e_idx

    def forward(self, x, s, mask, chain_m, residue_idx, chain_encoding_all,
                cls=None, return_rep: bool = False, enc_state=None,
                return_enc: bool = False, train: bool = False,
                detach_repr: bool = False, generator: Optional[torch.Generator] = None):
        """x [B,L,4,3], s [B,L] tokens (or [B,L,22] soft one-hot), masks
        [B,L]. Returns log_probs [B,L,22] f32 (+ zs_single, zs_pair,
        zs_structure, e_idx when return_rep). return_enc returns the encoder
        state (h_v, h_e, e_idx) instead; pass it back as enc_state so only
        the decoder runs. `train` turns on dropout and coordinate noise,
        drawn from `generator`; `detach_repr` keeps the projectors' gradient
        out of the trunk (projector-only training)."""
        del chain_m  # part of the batch schema; the model does not read it
        drop = Dropout(self.dropout, train, generator)
        cls_emb = None
        if self.use_cfg and cls is not None:
            cls_emb = self.cls_embedder(cls)
        if enc_state is None:
            enc_state = self.encode(x, mask, residue_idx, chain_encoding_all, cls_emb,
                                    train=train, generator=generator, drop=drop)
            if return_enc:
                return enc_state
        h_v, h_e, e_idx = enc_state
        mask = mask.to(h_v.dtype)
        zs_structure_raw = h_v

        if s.dim() > 2 and s.shape[-1] == self.vocab:
            h_s = s.to(h_v.dtype) @ self.W_s.weight
        else:
            h_s = self.W_s(s)
        h_es = torch.cat([h_e, gather_nodes(h_s, e_idx)], dim=-1)

        zs_single_raw, zs_pair_raw = h_v, h_es
        for i, layer in enumerate(self.decoder_layers):
            if cls_emb is not None:
                h_v = h_v + self.cls_layers_dec[i](cls_emb)[:, None, :]
            h_v, h_es_new = layer(h_v, h_es, e_idx, mask, fused=self.fused, drop=drop,
                                  parallel=self.parallel)
            if self.update_edge:
                h_es = h_es_new
            if i == self.align_depth:
                zs_single_raw, zs_pair_raw = h_v, h_es_new

        logits = self.W_out(h_v).float()
        if self.mdlm_parameterization:
            is_mask = torch.arange(self.vocab, device=logits.device) == MASK_TOKEN_INDEX
            logits = logits.masked_fill(is_mask, NEG_INF)
            log_probs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
            s_idx = s if s.dim() == 2 else torch.argmax(s, dim=-1)
            unmasked = (s_idx != MASK_TOKEN_INDEX)[..., None]
            onehot = s_idx[..., None] == torch.arange(self.vocab, device=s_idx.device)
            log_probs = torch.where(
                unmasked, torch.where(onehot, 0.0, NEG_INF), log_probs)
        else:
            log_probs = torch.log_softmax(logits, dim=-1)
        if not return_rep:
            return log_probs
        if detach_repr:
            zs_single_raw, zs_pair_raw, zs_structure_raw = (
                zs_single_raw.detach(), zs_pair_raw.detach(), zs_structure_raw.detach())
        zs_single = self._project(self.projectors_single, zs_single_raw.float())
        zs_pair = self._project(self.projectors_pair, zs_pair_raw.float())
        zs_structure = self._project(self.projectors_structure, zs_structure_raw.float())
        return log_probs, zs_single, zs_pair, zs_structure, e_idx

    def _project(self, proj: nn.Sequential, x):
        """A projector on f32 x: whole, or its column/row pair under the
        tensor axis (the outputs summed over the group, whole on every rank)."""
        if self.tensor == 1:
            return proj(x)
        return column_row(x, proj[0], proj[2], F.silu, self.parallel)


def create_pmpnn(device=None, generator: Optional[torch.Generator] = None,
                 **kwargs) -> ProteinMPNNFMIF:
    """A ProteinMPNNFMIF on `device` (default: the current default device),
    in f32, initialised from `generator`."""
    with torch.device(device) if device is not None else contextlib.nullcontext():
        return ProteinMPNNFMIF(**kwargs).initialize_weights(generator)
