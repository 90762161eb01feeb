"""UniMol global-representation encoder: the frozen molecule encoder of
GEOM-Drugs representation guidance. Counterpart of
reed_tpu/encoders/unimol.py (reference: molecule/models/unimol/unimol/
models/unimol_global.py:20-330 and unicore's TransformerEncoderWithPair),
the `output_global_rep_only=True` route the REED pipelines call
(molecule/semlaflow/flowmodels/encoders.py:258-330).

Token embeddings with BOS/EOS framing, Gaussian pair-distance features per
(atom type, atom type) edge type, a pre-LN pair-biased transformer in which
each layer's pre-softmax logits become the next layer's pair bias, mean
pooling, a 3-layer GELU head and a parameter-free standardisation. The
numerics are reed_tpu's: padded keys take NEG_INF = -1e9 (the reference's
-inf), LayerNorms eps 1e-6 (flax's default), GELU exact (erf), the mean
pooling UNMASKED over the padded sequence (padded positions keep their
evolved values, as the reference pools them), the standardisation by the
unbiased std (ddof 1, torch's .std()). f32.

Parameters carry the reference torch names (`embed_tokens`, `gbf.means`,
`gbf_proj.linear1`, `encoder.layers.{i}.self_attn.in_proj` with q|k|v
packed, `global_rep_head.{0,2,4}`, ...), so a reference checkpoint loads
after a prefix strip (encoders/unimol_convert.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9
LN_EPS = 1e-6  # flax's LayerNorm default, which reed_tpu computes with


def gaussian(x, mean, std):
    a = (2 * math.pi) ** 0.5
    return torch.exp(-0.5 * (((x - mean) / std) ** 2)) / (a * std)


class GaussianLayer(nn.Module):
    """Per-edge-type affine distance -> K Gaussian features (reference:
    unimol.py:421-441)."""

    def __init__(self, k: int = 128, edge_types: int = 1024):
        super().__init__()
        self.means = nn.Embedding(1, k)
        self.stds = nn.Embedding(1, k)
        self.mul = nn.Embedding(edge_types, 1)
        self.bias = nn.Embedding(edge_types, 1)

    def forward(self, dist, edge_type):
        """dist [B,N,N], edge_type [B,N,N] -> [B,N,N,K]."""
        mul = self.mul(edge_type)[..., 0]
        bias = self.bias(edge_type)[..., 0]
        x = (mul * dist + bias)[..., None]
        return gaussian(x, self.means.weight.reshape(-1),
                        torch.abs(self.stds.weight.reshape(-1)) + 1e-5)


class NonLinearHead(nn.Module):
    """linear2(gelu(linear1(x))) (reference: unimol.py NonLinearHead)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_in)
        self.linear2 = nn.Linear(d_in, d_out)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SelfMultiheadAttention(nn.Module):
    """unicore's self-attention with a packed q|k|v in_proj; returns the
    output and the pre-softmax logits (incoming bias included)."""

    def __init__(self, embed_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, attn_bias):
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = torch.chunk(self.in_proj(x), 3, dim=-1)
        q = (q * hd ** -0.5).reshape(b, n, self.heads, hd)
        k = k.reshape(b, n, self.heads, hd)
        v = v.reshape(b, n, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) + attn_bias
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, d)
        return self.out_proj(o), logits


class PairBiasedLayer(nn.Module):
    """Pre-LN transformer layer whose attention logits are the next layer's
    pair bias (unicore TransformerEncoderLayer, post_ln False)."""

    def __init__(self, embed_dim: int, ffn_dim: int, heads: int):
        super().__init__()
        self.self_attn = SelfMultiheadAttention(embed_dim, heads)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x, attn_bias):
        """x [B,N,D]; attn_bias [B,H,N,N] (NEG_INF at padded keys)."""
        o, logits = self.self_attn(self.self_attn_layer_norm(x), attn_bias)
        x = x + o
        x = x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))
        return x, logits


class _Encoder(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, heads: int, layers: int):
        super().__init__()
        self.emb_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.layers = nn.ModuleList(PairBiasedLayer(embed_dim, ffn_dim, heads)
                                    for _ in range(layers))


class UniMolGlobal(nn.Module):
    """forward(src_tokens [B,N] (0 = pad; BOS/EOS included), src_distance
    [B,N,N], src_edge_type [B,N,N] = type_i * vocab + type_j) -> the
    standardised global rep [B, rep_dim], f32."""

    def __init__(self, vocab_size: int = 32, embed_dim: int = 512, ffn_dim: int = 2048,
                 heads: int = 64, layers: int = 15, gaussian_k: int = 128, rep_dim: int = 512,
                 padding_idx: int = 0):
        super().__init__()
        self.padding_idx = padding_idx
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim, padding_idx)
        self.gbf = GaussianLayer(gaussian_k, vocab_size * vocab_size)
        self.gbf_proj = NonLinearHead(gaussian_k, heads)
        self.encoder = _Encoder(embed_dim, ffn_dim, heads, layers)
        self.global_rep_head = nn.Sequential(
            nn.Linear(embed_dim, embed_dim), nn.GELU(), nn.Linear(embed_dim, embed_dim),
            nn.GELU(), nn.Linear(embed_dim, rep_dim))

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """Seeded weights (the encoder is frozen and normally loaded): N(0,
        0.02) linears and embeddings, zero biases, the Gaussian means and
        stds U(0, 3) (the reference's), unit per-type scales and zero
        shifts, unit LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, std=0.02, generator=generator)
                if isinstance(m, nn.Linear):
                    nn.init.zeros_(m.bias)
        for p in (self.gbf.means.weight, self.gbf.stds.weight):
            nn.init.uniform_(p, 0.0, 3.0, generator=generator)
        nn.init.ones_(self.gbf.mul.weight)
        nn.init.zeros_(self.gbf.bias.weight)
        return self

    def forward(self, src_tokens, src_distance, src_edge_type):
        padding = src_tokens == self.padding_idx
        x = self.embed_tokens(src_tokens)
        gbf = self.gbf(src_distance, src_edge_type)
        attn_bias = self.gbf_proj(gbf).permute(0, 3, 1, 2)                 # [B,H,N,N]
        attn_bias = attn_bias.masked_fill(padding[:, None, None, :], NEG_INF)
        x = self.encoder.emb_layer_norm(x)
        x = x * (1.0 - padding[..., None].to(x.dtype))
        for layer in self.encoder.layers:
            x, attn_bias = layer(x, attn_bias)
        x = self.encoder.final_layer_norm(x)
        # the mean over the whole padded sequence, as the reference pools
        # encoder_rep.mean(dim=1) (unimol_global.py:290-292)
        rep = self.global_rep_head(torch.mean(x, dim=1)).float()
        mean = rep.mean(dim=-1, keepdim=True)
        std = rep.std(dim=-1, keepdim=True)  # unbiased, ddof 1
        return (rep - mean) / (std + 1e-6)


def format_input_to_unimol(atom_types, coords, mask, bos_idx: int = 1, eos_idx: int = 2,
                           offset: int = 3):
    """A dense molecule batch (numpy: vocabulary ids [B,N], coords [B,N,3],
    mask [B,N]) -> UniMol inputs (tokens [B,N+2], distances [B,N+2,N+2],
    edge types [B,N+2,N+2]) with BOS/EOS framing; the UniMol dictionary
    reserves 0 = pad, 1 = bos, 2 = eos (reference: encoders.py:221-257)."""
    b, n = atom_types.shape
    tokens = np.zeros((b, n + 2), np.int32)
    dist = np.zeros((b, n + 2, n + 2), np.float32)
    pos = np.zeros((b, n + 2, 3), np.float32)
    for i in range(b):
        k = int(mask[i].sum())
        tokens[i, 0] = bos_idx
        tokens[i, 1:k + 1] = np.asarray(atom_types[i][:k]) + offset
        tokens[i, k + 1] = eos_idx
        pos[i, 1:k + 1] = coords[i][:k]
        d = np.linalg.norm(pos[i][:, None] - pos[i][None], axis=-1)
        dist[i, :k + 2, :k + 2] = d[:k + 2, :k + 2]
    edge_type = tokens[:, :, None] * 32 + tokens[:, None, :]
    return tokens, dist, edge_type.astype(np.int32)
