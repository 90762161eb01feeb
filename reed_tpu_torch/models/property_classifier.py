"""EGNN property regressor for conditional-generation evaluation,
counterpart of reed_tpu/models/property_classifier.py (reference:
molecule/qm9/property_prediction/models_property.py): an EGNN with
feature-only message passing (no coordinate updates; squared distances as
edge features), sum pooling and an MLP head predicting one scalar
molecular property (alpha, mu, HOMO, ...). It scores the molecules of
conditional generation (molecule/eval_src/eval_conditional_qm9.py:18).

Dense-batched like models/egnn.py: node features [B, N, d], pair tensors
[B, N, N, c]. Parameters carry reed_tpu's flax module names (`embedding`,
`gcl_{i}.edge_fc1`, `gcl_{i}.att`, `node_dec_fc1`, `graph_dec_fc2`, ...),
so encoders/property_convert.py maps the two trees name for name. The
edge MLP's first layer acts on concat([h_i, h_j, edge_attr]) through the
column blocks of its one weight (models/egnn.factored_pair_linear), as
reed_tpu's DenseParams slices its kernel's rows, so the [B, N, N, 2d + 1]
concat is never built. f32 (f64 for a reference check).

Under the tensor axis (`parallel`, parallel/mesh.EGNN_TP_RULES) each
layer's edge and node MLPs are Megatron column/row pairs, as the EDM's GCL
(models/egnn.py): a rank holds edge_fc1's and node_fc1's hidden columns
and edge_fc2's and node_fc2's matching rows, the second products' f32
partials are summed over the tensor group before their biases, and the
embedding, the attention and the decoders are whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.models.egnn import coord2diff, factored_pair_linear
from reed_tpu_torch.nn.layers import row_dense, split_width, tensor_size
from reed_tpu_torch.parallel.collectives import copy_to_tensor


class PropertyEGNNLayer(nn.Module):
    """One message-passing layer: the edge MLP over [h_i | h_j | edge_attr]
    with a sigmoid edge attention, masked sum over neighbours, and a
    residual node MLP."""

    def __init__(self, hidden_nf: int, edges_in_d: int = 1, attention: bool = True,
                 parallel=None):
        super().__init__()
        self.attention = attention
        self.parallel = parallel
        edge_hidden = split_width(hidden_nf, tensor_size(parallel), "the edge MLP")
        node_hidden = split_width(hidden_nf, tensor_size(parallel), "the node MLP")
        self.edge_fc1 = nn.Linear(2 * hidden_nf + edges_in_d, edge_hidden)
        self.edge_fc2 = nn.Linear(edge_hidden, hidden_nf)
        if attention:
            self.att = nn.Linear(hidden_nf, 1)
        self.node_fc1 = nn.Linear(2 * hidden_nf, node_hidden)
        self.node_fc2 = nn.Linear(node_hidden, hidden_nf)

    def forward(self, h, edge_attr, node_mask, edge_mask):
        parallel, dt = self.parallel, self.edge_fc2.weight.dtype
        m = F.silu(factored_pair_linear(self.edge_fc1, copy_to_tensor(h, parallel),
                                        copy_to_tensor(edge_attr, parallel)))
        m = F.silu(row_dense(m, self.edge_fc2, dt, parallel))
        if self.attention:
            m = m * torch.sigmoid(self.att(m))
        agg = torch.sum(m * edge_mask, dim=2)
        out = F.silu(self.node_fc1(copy_to_tensor(torch.cat([h, agg], dim=-1), parallel)))
        out = row_dense(out, self.node_fc2, dt, parallel)
        return (h + out) * node_mask


class PropertyClassifier(nn.Module):
    """embedding -> n_layers PropertyEGNNLayers -> node decoder -> sum pool
    -> graph decoder -> one scalar a molecule; `parallel` splits the
    layers over its tensor axis (the module docstring)."""

    def __init__(self, in_node_nf: int, hidden_nf: int = 128, n_layers: int = 7,
                 attention: bool = True, parallel=None):
        super().__init__()
        self.n_layers = n_layers
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", PropertyEGNNLayer(hidden_nf, 1, attention, parallel))
        self.node_dec_fc1 = nn.Linear(hidden_nf, hidden_nf)
        self.node_dec_fc2 = nn.Linear(hidden_nf, hidden_nf)
        self.graph_dec_fc1 = nn.Linear(hidden_nf, hidden_nf)
        self.graph_dec_fc2 = nn.Linear(hidden_nf, 1)

    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's (flax's default) initialisation: lecun-normal weights (a
        normal truncated at 2 sigma, scaled to variance 1 / fan_in; fan_in
        2d + 1 for edge_fc1, as for DenseParams' whole kernel) and zero
        biases."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
        return self

    def forward(self, h0, x, node_mask, edge_mask):
        """h0 [B,N,F] one-hot node features, x [B,N,3] coordinates, masks
        [B,N,1] and [B,N,N,1] -> the property prediction [B], in the
        parameters' dtype (f32)."""
        radial, _ = coord2diff(x)
        h = self.embedding(h0.to(self.embedding.weight.dtype)) * node_mask
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, radial, node_mask, edge_mask)
        h = self.node_dec_fc2(F.silu(self.node_dec_fc1(h))) * node_mask
        g = F.silu(self.graph_dec_fc1(torch.sum(h, dim=1)))
        return self.graph_dec_fc2(g)[..., 0]


def conditional_generation_mae(classifier_fn, molecules, targets) -> float:
    """MAE of a trained property classifier on generated molecules against
    the conditioning targets, in f32 (reference: eval_conditional_qm9.py)."""
    preds = torch.as_tensor(classifier_fn(molecules)).float()
    targets = torch.as_tensor(targets, dtype=torch.float32, device=preds.device)
    return float(torch.mean(torch.abs(preds - targets)))
