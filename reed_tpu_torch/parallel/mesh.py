"""The four mesh axes over torch.distributed, counterpart of
reed_tpu/parallel/mesh.py.

reed_tpu runs one jit over the global batch on a ('data', 'fsdp', 'seq',
'tensor') mesh: its gradient is the gradient of the global batch's loss
and its draws are the global batch's draws. The port runs one process a
rank (launched by torchrun; NCCL with one card a rank, or gloo), laid out
as make_mesh reshapes the devices: rank = ((d * F + f) * S + s) * T + t
for data, fsdp, seq and tensor indices d, f, s, t of sizes D, F, S, T.

The batch side is data x fsdp: batch index b = d * F + f holds rows [b *
B / W, (b + 1) * B / W) of the global batch of B rows over W = D * F, the
layout reed_tpu's batch_sharding (over data x fsdp) gives a one-process
mesh; `DataParallel.rank` and `.world` are b and W. A step then equals
reed_tpu's:
  * each batch index's loss is written so that its mean over the batch
    indices is the global batch's loss (a mean of per-sample terms over
    equal local batches is; a loss normalised by a count over the batch
    takes the global count, diffusion/protein_losses.py), so the mean of
    their gradients is the global batch's gradient;
  * every rank draws each batch draw at the global shape from the one
    generator all ranks share and keeps the rows of its batch index
    (parallel/draws.py), and builds host batches (OT couplings included)
    as one process would before it keeps its rows (`local_rows`). The seq
    and tensor ranks of one batch index draw the same.

The fsdp axis shards the parameters at rest and the optimizer's state
(reed_tpu's shard_params over `fsdp_spec`, ZeRO-3). A parameter that
fsdp_spec shards (`ShardPlan`) is owned in F contiguous flat chunks, chunk
f by the ranks of fsdp index f, and between steps a rank holds only its
chunk: the model's parameter is that chunk, and so are Adam's moments, the
accumulation buffer and the EMA. The model's parameters are gathered where
its code reads them, a unit at a time (`ShardPlan.units`: SiT's blocks one
by one, the rest of a model in one), by `_GatherChunks` inside the
autograd graph: its forward all-gathers the unit's chunks over the fsdp
group (the F ranks that share d, s, t), its backward reduce-scatters the
unit's gradient over that group, all-reduces it over the D * S ranks that
share (f, t) and divides by D * F * S, so the step's autograd.grad hands
the chunks their reduced gradients and no gather follows the update.
Replicated parameters keep a bucketed all-reduce over the replica group
(the D * F * S ranks of one tensor index). A run equals the one-process
run up to the order of the reductions, and a checkpoint stays one file
with one generator state.

The tensor and seq axes split the model's work. Under tensor each rank
holds T-th shards of a model's products and the T ranks of a tensor group
(T consecutive ranks) run one model between them (parallel/collectives.py):
SiT's blocks (`SIT_TP_RULES`: Megatron's column-parallel qkv and fc1,
row-parallel proj and fc2, qkv split by heads), ProteinMPNN's message
chains, feed-forwards, edge update and projectors (`PMPNN_TP_RULES`),
SemlaFlow's (`SEMLA_TP_RULES`), the EGNN family's (`EGNN_TP_RULES`),
MultiFlow's IPA heads and sequence transformer (`ipa_tp_rules`) and the
RDM's residual blocks (`RDM_TP_RULES`). Semla's egnn and eqgat archs and
the property linear probe run whole on every tensor rank, as reed_tpu's
rules, which name none of their leaves, leave them. Under seq (SiT only)
each rank runs its S-th of the tokens, attending to every rank's keys.
Every seq and tensor rank computes the whole loss; the parameter
gradients are averaged over the replica group. A caller names
the model axes its family runs to `check_mesh` (every trainer, sampler and
eval subcommand: tensor; SiT's: seq too), and a size above 1 outside them
raises (NOT_PORTED).

Evaluation and sampling split each global batch over the batch indices as
np.array_split does (`DataParallel.rows`: the batches need not divide, and
an index may hold none), draw inside draws.global_rows(dp, n), and
`DataParallel.gather_rows(x, n)` stacks the rows back in batch order.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import re
import types
import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from reed_tpu_torch import resolve_device
from reed_tpu_torch.core.config import MeshConfig
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.draws import split_rows

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, TENSOR_AXIS)

# the model axes each family runs (check_mesh's `axes`): SiT splits its heads,
# MLP and tokens; ProteinMPNN its message chains and MLPs; SemlaFlow (arch
# semla) its message MLPs, node attention heads and feed-forwards; the EGNN
# family (EDM / EFM and the property classifier) its message, node,
# coordinate and rep feed-forward MLPs; MultiFlow its IPA heads and sequence
# transformer; the RDM its residual blocks' MLPs. SemlaFlow's egnn and
# eqgat archs (SEMLA_AXES, no rule names a leaf of theirs) and the property
# linear probe (EGNN_AXES) run whole on every tensor rank. Each eval
# subcommand runs its family's.
SIT_AXES = (TENSOR_AXIS, SEQ_AXIS)
PMPNN_AXES = (TENSOR_AXIS,)
SEMLA_AXES = (TENSOR_AXIS,)
EGNN_AXES = (TENSOR_AXIS,)
IPA_AXES = (TENSOR_AXIS,)
RDM_AXES = (TENSOR_AXIS,)

# the families that run each model axis (check_mesh's message)
RUNS_TENSOR = ("every trainer (train-image, train-protein, train-molecule-semla, "
               "train-molecule-edm, train-property, train-rdm, train-multiflow), "
               "generate-image and the eval subcommands (eval-protein, eval-semla, "
               "eval-molecule, eval-conditional, eval-multiflow)")

# why a model axis above 1 raises for a caller that does not run it
NOT_PORTED = {
    TENSOR_AXIS: "not run: the caller names no model axis, so no model of its splits "
                 "over the tensor ranks (a family names its axes: SIT_AXES, PMPNN_AXES, "
                 "SEMLA_AXES, EGNN_AXES, IPA_AXES, RDM_AXES)",
    SEQ_AXIS: "not run: the seq axis splits SiT's tokens alone (reed_tpu's "
              "token_sharding touches no other model, and its seq ranks there would "
              "only repeat each other's work; ROADMAP.md Queue 1 item 8b)",
}

# elements a gradient bucket holds at most (256 MB in f32): SiT-XL/2's
# 675 M parameters go in 11 all-reduces
BUCKET_ELEMENTS = 1 << 26

# reed_tpu's minimum leaf size (elements) for fsdp sharding
FSDP_MIN_SIZE = 65536

# reed_tpu's SIT_TP_RULES in the port's names: (pattern, dimension of the
# torch weight [out, in] or bias, groups). reed_tpu shards the qkv and fc1
# kernels' columns (P(None, 'tensor') on [in, out]: the torch weight's
# dimension 0) and the proj and fc2 kernels' rows (dimension 1). Its rules
# are layout hints and leave the biases replicated; here the split is real,
# so the qkv and fc1 biases split with their columns, while the proj and fc2
# biases stay whole and are added once after the reduce. qkv's dimension 0
# is 3 groups (q, k, v) of heads x head dim: a rank takes its heads of each.
SIT_TP_RULES = (
    (r"\.attn\.qkv\.(weight|bias)$", 0, 3),
    (r"\.attn\.proj\.weight$", 1, 1),
    (r"\.mlp\.fc1\.(weight|bias)$", 0, 1),
    (r"\.mlp\.fc2\.weight$", 1, 1),
)

# reed_tpu's PMPNN_TP_RULES in the port's names, as (pattern, dimension,
# groups) like SIT_TP_RULES: column-parallel products split dimension 0 of
# the torch weight [out, in] and their bias, row-parallel ones dimension 1,
# with their bias whole and added once after the reduce (Megatron's pair).
# Departures from reed_tpu's hints, which are layout hints under GSPMD and
# split no work themselves:
#  * each message chain W3(gelu(W2(gelu(W1 [h_i, e_ik, h_j])))) (the
#    encoder's W1-W3 and W11-W13, the decoder's W1-W3): reed_tpu shards
#    W1's columns and W3's rows around a whole W2, which needs all of W1's
#    output, so no rank could skip any of W2's work. Here W1 (W11) is whole
#    on every rank, W2 (W12) is split by its output columns with its bias
#    and W3 (W13) by its input rows: each rank runs the whole first product
#    and its H = D / T columns of the second, returns partial messages that
#    the tensor group sums, and b3 is added once (ops/fused_message.py);
#  * the feed-forwards (dense.W_in / dense.W_out): reed_tpu's patterns
#    'dense/fc1/kernel' and 'dense/fc2/kernel' name leaves its model does not
#    have (its feed-forward's are dense/Dense_0 and dense/Dense_1), so it
#    keeps them whole; here they are the column/row pair the patterns meant;
#  * the projectors' second products (projectors_*.2): reed_tpu's pattern
#    'projectors_\w+/Dense_2/kernel' matches no leaf (a projector's are
#    Dense_0 and Dense_1), so only the first product's columns carry its
#    hint; here the second is the row-parallel half of the pair;
#  * the biases of the column-parallel products (dense.W_in, W_edge.1,
#    projectors_*.0) split with their columns, where reed_tpu leaves every
#    bias replicated.
# The rest (features, W_e, W_s, W_out, LayerNorms) is whole on every rank.
PMPNN_TP_RULES = (
    (r"\.dense\.W_in\.(weight|bias)$", 0, 1),
    (r"\.dense\.W_out\.weight$", 1, 1),
    (r"\.W(2|12)\.(weight|bias)$", 0, 1),
    (r"\.W(3|13)\.weight$", 1, 1),
    (r"\.W_edge\.1\.(weight|bias)$", 0, 1),
    (r"\.W_edge\.3\.weight$", 1, 1),
    (r"^projectors_\w+\.0\.(weight|bias)$", 0, 1),
    (r"^projectors_\w+\.2\.weight$", 1, 1),
)

# reed_tpu's SEMLA_TP_RULES (reed_tpu/parallel/mesh.py:199-208) in the
# port's names (the reference torch SemlaFlow's, models/semla.py), as
# (pattern, dimension, groups) like SIT_TP_RULES: inv_fc1/inv_fc2 are every
# NodeFeedForward's invariant MLP (the layers' node_ff and final_ff_block),
# message_fc1/message_fc2 the edge-message MLPs (the layers' message_ff and
# BondRefine's, which reed_tpu's pattern matches too), node_attn/in_proj and
# out_proj the node attention (in_proj's columns are heads x head dim, so a
# contiguous split is a rank's heads), feat_proj_fc1/fc2 the input feature
# projection. The column-parallel products' biases split with their
# columns (reed_tpu's hints leave every bias replicated); the row-parallel
# ones' stay whole and are added once after the f32 sum. Whole on every
# rank: the coordinate paths, the RepConditioner, the norms, node_proj, the
# edge in/out projections, the projectors and the heads.
SEMLA_TP_RULES = (
    (r"\.invariant_mlp\.node_ff\.0\.(weight|bias)$", 0, 1),
    (r"\.invariant_mlp\.node_ff\.2\.weight$", 1, 1),
    (r"\.message_mlp\.0\.(weight|bias)$", 0, 1),
    (r"\.message_mlp\.2\.weight$", 1, 1),
    (r"\.node_attn\.in_proj\.(weight|bias)$", 0, 1),
    (r"\.node_attn\.out_proj\.weight$", 1, 1),
    (r"^feat_proj\.0\.(weight|bias)$", 0, 1),
    (r"^feat_proj\.2\.weight$", 1, 1),
)

# reed_tpu's EGNN_TP_RULES (reed_tpu/parallel/mesh.py:212-222) in the
# port's names: the EDM's (the reference torch EGNN_dynamics_QM9's,
# models/egnn.py) and the property classifier's (reed_tpu's flax names,
# models/property_classifier.py). edge_fc1/edge_fc2 and node_fc1/node_fc2
# are each GCL's edge_mlp.0/.2 and node_mlp.0/.2 (the classifier's
# gcl_{i}.edge_fc1 ...), coord_fc1/coord_fc2 each EquivariantUpdate's
# coord_mlp.0/.2 (the scalar head coord_mlp.4 stays whole after the sum),
# ff_proj/ff_out the rep cross-attention's GEGLU feed-forward: ff.net.0.proj
# emits the halves [a, g] of 4d each, so it splits in 2 groups (a rank takes
# the same columns c_t of both halves), and ff.net.2 by rows. The biases
# split as SEMLA_TP_RULES'. Whole on every rank: the embeddings, att_mlp,
# the cross-attention's to_q/to_k/to_v/to_out, the norms, fake_latent and
# the classifier's decoders.
EGNN_TP_RULES = (
    (r"\.edge_mlp\.0\.(weight|bias)$", 0, 1),
    (r"\.edge_mlp\.2\.weight$", 1, 1),
    (r"\.node_mlp\.0\.(weight|bias)$", 0, 1),
    (r"\.node_mlp\.2\.weight$", 1, 1),
    (r"\.coord_mlp\.0\.(weight|bias)$", 0, 1),
    (r"\.coord_mlp\.2\.weight$", 1, 1),
    (r"\.ff\.net\.0\.proj\.(weight|bias)$", 0, 2),
    (r"\.ff\.net\.2\.weight$", 1, 1),
    (r"^gcl_\d+\.(edge|node)_fc1\.(weight|bias)$", 0, 1),
    (r"^gcl_\d+\.(edge|node)_fc2\.weight$", 1, 1),
)


# reed_tpu's IPA_TP_RULES (reed_tpu/parallel/mesh.py:225-237, applied at
# reed_tpu/train/multiflow.py:181-182) in the port's names (the reference
# torch FlowModel's, models/ipa.py), as (pattern, dimension, groups) like
# SIT_TP_RULES, for an IPA of `no_heads` heads of `c_hidden` channels,
# `no_v_points` value points and pair width `c_z`:
#  * linear_q and linear_kv ([H, c] and [H, 2c] head-major) split by heads
#    (groups 1); linear_q_points and linear_kv_points emit x, y and z as
#    three head-major column blocks of H * P (reed_tpu interleaves them,
#    encoders/multiflow_convert.py permutes), so they split in 3 groups: a
#    rank takes its heads out of each of x, y and z;
#  * linear_out is row-parallel over its input, which joins per head blocks
#    of unequal widths: o (H c), the point outputs' x, y, z and norms (H Pv
#    each) and o_pair (H c_z / 4); the groups are those block widths, each
#    split over the ranks (tensor_split);
#  * the sequence transformer's qkv, proj, fc1 and fc2 are the torch
#    layer's self_attn.in_proj ([q; k; v], each head-major: 3 groups),
#    self_attn.out_proj, linear1 and linear2, two Megatron pairs.
# The column-parallel products' biases split with their columns (reed_tpu's
# hints leave every bias replicated); the row-parallel ones' stay whole and
# are added once after the f32 sum. Whole on every rank, as reed_tpu's rules
# leave them: linear_b and down_z (their outputs [B,N,N,H] and [B,N,N,c_z/4]
# are made whole and enter the split attention through copy_to_tensor, a
# rank taking its heads of the bias), head_weights (copied the same way,
# then sliced), the feature nets, the norms, post_tfmr, the transitions,
# the backbone updates and the aatype head.
def ipa_tp_rules(no_heads: int = 8, c_hidden: int = 16, no_v_points: int = 12,
                 c_z: int = 128) -> tuple:
    """IPA_TP_RULES for an IPA of these widths (the defaults are
    MultiflowTrainConfig's)."""
    h = no_heads
    out_blocks = (h * c_hidden,) + (h * no_v_points,) * 4 + (h * (c_z // 4),)
    return (
        (r"\.ipa_\d+\.linear_(q|kv)\.(weight|bias)$", 0, 1),
        (r"\.ipa_\d+\.linear_(q|kv)_points\.(weight|bias)$", 0, 3),
        (r"\.ipa_\d+\.linear_out\.weight$", 1, out_blocks),
        (r"\.self_attn\.in_proj_(weight|bias)$", 0, 3),
        (r"\.self_attn\.out_proj\.weight$", 1, 1),
        (r"\.seq_tfmr_\d+\.layers\.\d+\.linear1\.(weight|bias)$", 0, 1),
        (r"\.seq_tfmr_\d+\.layers\.\d+\.linear2\.weight$", 1, 1),
    )


# at MultiflowTrainConfig's widths; a trainer takes those of its own
# configuration (train/multiflow.tp_rules)
IPA_TP_RULES = ipa_tp_rules()

# reed_tpu's RDM_TP_RULES (reed_tpu/parallel/mesh.py:240-245, applied at
# reed_tpu/train/rdm.py:90-91) in the port's names (the reference
# SimpleMLP's, models/rdm_mlp.py): each residual block's in_fc
# (in_layers.2), emb_fc (emb_layers.1) and context_fc (context_layers.1)
# split by columns with their biases, out_fc (out_layers.3) by rows, its
# bias whole and added once after the f32 sum. Departures: the biases
# split with their columns, and so do the scale and bias of out_norm
# (out_layers.0), the LayerNorm over the split mid width between the two
# halves, which reed_tpu leaves replicated: a rank normalises its columns
# with statistics summed over the tensor group (models/rdm_mlp.py). Whole on
# every rank: the time and class embeddings, input_proj, in_norm and the
# output head.
RDM_TP_RULES = (
    (r"^res_blocks\.\d+\.in_layers\.2\.(weight|bias)$", 0, 1),
    (r"^res_blocks\.\d+\.emb_layers\.1\.(weight|bias)$", 0, 1),
    (r"^res_blocks\.\d+\.context_layers\.1\.(weight|bias)$", 0, 1),
    (r"^res_blocks\.\d+\.out_layers\.0\.(weight|bias)$", 0, 1),
    (r"^res_blocks\.\d+\.out_layers\.3\.weight$", 1, 1),
)


def tensor_rule(name: str, rules: Sequence[tuple]) -> Optional[Tuple[int, object]]:
    """(dimension, groups) of the first rule whose pattern `name` matches,
    or None where the parameter is replicated over the tensor axis.
    `groups` is a count of equal groups or a tuple of block widths."""
    for pattern, dim, groups in rules:
        if re.search(pattern, name):
            return dim, groups
    return None


def _blocks(size: int, groups, tensor: int) -> Tuple[int, ...]:
    """The widths of the blocks of a dimension of `size` under `groups` (a
    count of equal groups or a tuple of widths), each to be split over
    `tensor` ranks; ValueError where they do not split."""
    if isinstance(groups, int):
        if size % (groups * tensor):
            raise ValueError(f"a dimension of {size} ({groups} groups) does not split "
                             f"over tensor={tensor}")
        return (size // groups,) * groups
    blocks = tuple(groups)
    if sum(blocks) != size:
        raise ValueError(f"blocks {blocks} do not make a dimension of {size}")
    if any(w % tensor for w in blocks):
        raise ValueError(f"blocks {blocks} do not split over tensor={tensor}")
    return blocks


def tensor_split(whole: torch.Tensor, rule: Tuple[int, object], tensor: int,
                 index: int) -> torch.Tensor:
    """Tensor rank `index`'s shard of `whole` under `rule` (dimension,
    groups): dimension `dim` read as blocks (`groups` equal ones, or the
    widths `groups` lists), each block split in `tensor` contiguous slices,
    and slice `index` of every block taken, in block order. Raises
    ValueError where the dimension does not split."""
    dim, groups = rule
    blocks = _blocks(whole.shape[dim], groups, tensor)
    parts = [block.narrow(dim, index * (w // tensor), w // tensor)
             for block, w in zip(whole.split(blocks, dim), blocks)]
    return torch.cat(parts, dim).contiguous()


def tensor_join(shards: Sequence[torch.Tensor], rule: Tuple[int, object]) -> torch.Tensor:
    """The whole tensor of the shards of every tensor rank, in rank order
    (the inverse of tensor_split)."""
    dim, groups = rule
    tensor = len(shards)
    if isinstance(groups, int):
        mine = (shards[0].shape[dim] // groups,) * groups
    else:
        mine = tuple(w // tensor for w in groups)
    pieces = [t.split(mine, dim) for t in shards]
    return torch.cat([piece for j in range(len(mine)) for piece in
                      (p[j] for p in pieces)], dim)


def shard_state_dict(state_dict: Mapping, parallel,
                     rules: Sequence[tuple]) -> Dict[str, torch.Tensor]:
    """A whole state_dict as tensor rank `parallel.tensor_index` of
    `parallel.tensor`'s (None or tensor 1: the whole one): each entry that
    a rule of `rules` names split by tensor_split, the rest as it is. The
    inverse is ShardPlan.join_state_dict, so checkpoints and reference
    weights stay one file of whole parameters whatever the tensor size."""
    if parallel is None or parallel.tensor == 1:
        return dict(state_dict)
    out = {}
    for name, value in state_dict.items():
        rule = tensor_rule(name, rules)
        out[name] = value if rule is None else tensor_split(
            value, rule, parallel.tensor, parallel.tensor_index)
    return out


def fsdp_spec(shape: Sequence[int], fsdp_size: int,
              min_size: int = FSDP_MIN_SIZE, taken: Optional[int] = None) -> Optional[int]:
    """The dimension of `shape` that reed_tpu's fsdp_spec shards over an
    fsdp axis of `fsdp_size`, or None where the leaf stays replicated: a
    leaf is sharded when it has at least 2 dimensions and `min_size`
    elements and some dimension (dimension 0 first, then the largest) other
    than `taken` (the one a tensor rule took, reed_tpu's tensor_spec) is
    divisible by fsdp_size and at least twice it. `shape` is the whole
    leaf's. Whether a leaf is sharded is the same for any order of its
    dimensions, so a torch Linear weight [out, in] is sharded exactly when
    the flax kernel [in, out] is; the dimension named is the one of the
    shape given. The port shards flat chunks, not this dimension
    (ShardPlan)."""
    if fsdp_size <= 1 or len(shape) < 2 or math.prod(shape) < max(1, min_size):
        return None
    order = [0] + sorted(range(1, len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i != taken and shape[i] % fsdp_size == 0 and shape[i] >= 2 * fsdp_size:
            return i
    return None


def check_mesh(mesh, world: int, batch_size: Optional[int] = None,
               axes: Sequence[str] = ()):
    """What stands in for reed_tpu's make_mesh: `mesh` (a MeshConfig) must
    ask for data * fsdp * seq * tensor = `world` ranks (data None takes the
    rest, as make_mesh's data=None does), and `batch_size` (the global
    batch) must split evenly over the data * fsdp batch indices. `axes`
    are the model axes the caller runs (SIT_AXES, PMPNN_AXES, SEMLA_AXES,
    EGNN_AXES, IPA_AXES, RDM_AXES); a tensor or seq
    size above 1 outside them raises NotImplementedError naming why
    (NOT_PORTED). Returns (data, fsdp); raises ValueError otherwise."""
    seq, tensor = mesh.seq or 1, mesh.tensor or 1
    for axis, size in ((TENSOR_AXIS, tensor), (SEQ_AXIS, seq)):
        if size > 1 and axis not in axes:
            raise NotImplementedError(
                f"mesh axis '{axis}' of size {size} does not run here: "
                f"the port runs 'tensor' on {RUNS_TENSOR}, and 'seq' on SiT; "
                f"'{axis}' here is {NOT_PORTED[axis]}")
    fsdp = mesh.fsdp or 1
    inner = fsdp * seq * tensor
    axes = f"fsdp={fsdp}" + "".join(f" x {a}={n}" for a, n in ((SEQ_AXIS, seq),
                                                              (TENSOR_AXIS, tensor)) if n > 1)
    names = "data x fsdp" + (" x seq x tensor" if seq * tensor > 1 else "")
    if min(fsdp, seq, tensor) < 1 or world % inner:
        raise ValueError(
            f"mesh {axes} does not divide the {world} process(es) that run: launch "
            f"{names} ranks (torchrun --nproc_per_node {inner} -m reed_tpu_torch.cli "
            "... --distributed)")
    data = world // inner if mesh.data is None else mesh.data
    if data * inner != world:
        sizes = " x ".join(str(n) for n in (data, fsdp) + ((seq, tensor) if seq * tensor > 1
                                                          else ()))
        raise ValueError(
            f"mesh data={data}, but {world} process(es) run, and {names} = {sizes} "
            f"ranks: launch one process a rank (torchrun --nproc_per_node "
            f"{data * inner} -m reed_tpu_torch.cli ... --distributed)")
    if batch_size is not None and batch_size % (data * fsdp):
        raise ValueError(f"a global batch of {batch_size} does not split over "
                         f"{data * fsdp} ranks")
    return data, fsdp


def _slice_rows(x, span):
    """The rows span(B) = (start, count) of every array and tensor in `x`
    (nested dicts, lists and tuples; other leaves and 0-d arrays as they
    are), B its leading size."""
    if isinstance(x, dict):
        return {k: _slice_rows(v, span) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_slice_rows(v, span) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
        start, count = span(x.shape[0])
        return x[start:start + count]
    return x


def _join_rows(parts):
    """Nested tensors of several row ranges, concatenated leaf by leaf."""
    if isinstance(parts[0], dict):
        return {k: _join_rows([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], (list, tuple)):
        return type(parts[0])(_join_rows(list(p)) for p in zip(*parts))
    return torch.cat(parts)


def local_rows(x, rank: int, world: int):
    """Rank `rank`'s rows [rank*B/W, (rank+1)*B/W) of every array and
    tensor in `x` (nested dicts, lists and tuples; other leaves and 0-d
    arrays as they are), B its leading size. Raises ValueError when the
    world size does not divide B."""
    def span(n):
        if n % world:
            raise ValueError(f"a global batch of {n} rows does not split over "
                             f"{world} ranks")
        return rank * (n // world), n // world

    return _slice_rows(x, span)


def local_batch(dp, batch):
    """This rank's rows of a global batch under `dp` (a DataParallel), the
    batch itself with dp None."""
    return batch if dp is None else local_rows(batch, dp.rank, dp.world)


def run_rows(dp, n: int, batch, fn):
    """Sharded evaluation's pattern: fn(rows) on this batch index's rows
    (DataParallel.take_rows) of the global `batch` of n rows (nested
    tensors and arrays), inside draws.global_rows(dp, n) so that every draw
    is made at the global shape, its output (nested tensors with n rows)
    gathered back in batch order on every rank. A batch index with no rows
    (n < W: all its tensor ranks together) skips fn and joins the gather.
    With dp None: fn(batch)."""
    if dp is None:
        return fn(batch)
    with draws.global_rows(dp, n):
        out = fn(dp.take_rows(batch, n)) if dp.rows(n)[1] else None
    return dp.gather_rows(out, n)


def rows_apart(world: int, n: int, batch, fn):
    """What `world` data ranks compute with run_rows, in one process: fn on
    each batch index's rows of the global `batch` of n rows (an index
    holding none skipped), inside draws.global_rows for that index, the
    outputs joined in batch order. The witness a data-parallel run is held
    to (the tests, chip_smoke.py): its ranks run the same products on the
    same rows with the same draws."""
    starts, counts = split_rows(n, world)
    parts = []
    for rank in range(world):
        if counts[rank]:
            span = (int(starts[rank]), int(counts[rank]))
            with draws.global_rows(types.SimpleNamespace(rank=rank, world=world), n):
                parts.append(fn(_slice_rows(batch, lambda _, span=span: span)))
    return _join_rows(parts)


def _buckets(sizes: Sequence[int], dtypes: Sequence[torch.dtype],
             cap: Optional[int] = None) -> List[List[int]]:
    """The indices of `sizes` in flat buckets of one dtype and up to `cap`
    (default BUCKET_ELEMENTS) elements each (a larger one alone), in
    order within each dtype."""
    cap = BUCKET_ELEMENTS if cap is None else cap
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)
    out = []
    for idx in by_dtype.values():
        part, size = [], 0
        for i in idx:
            if part and size + sizes[i] > cap:
                out.append(part)
                part, size = [], 0
            part.append(i)
            size += sizes[i]
        if part:
            out.append(part)
    return out


# (default group, data, fsdp, seq, tensor) -> this rank's groups
_subgroups: Dict = {}

# the axes that vary within each group of a rank (the others are fixed)
GROUP_AXES = {
    "tensor": (TENSOR_AXIS,),              # one model's shards
    "seq": (SEQ_AXIS,),                    # one model's token slices
    "fsdp": (FSDP_AXIS,),                  # one chunking of the sharded state
    "data": (DATA_AXIS, SEQ_AXIS),         # the ranks that share (f, t)
    "replica": (DATA_AXIS, FSDP_AXIS, SEQ_AXIS),  # the ranks of one tensor index
    "batch": (DATA_AXIS, FSDP_AXIS),       # one rank a batch index
}


def mesh_coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """{axis: index} of `rank` on make_mesh's row-major (data, fsdp, seq,
    tensor) layout with axis sizes `sizes`."""
    coords = {}
    for axis in reversed(MESH_AXES):
        coords[axis] = rank % sizes[axis]
        rank //= sizes[axis]
    return coords


def mesh_rank(coords: Dict[str, int], sizes: Dict[str, int]) -> int:
    """The rank at `coords` (the inverse of mesh_coords)."""
    rank = 0
    for axis in MESH_AXES:
        rank = rank * sizes[axis] + coords[axis]
    return rank


def group_ranks(kind: str, rank: int, sizes: Dict[str, int]) -> List[int]:
    """The ranks of `rank`'s group of `kind` (GROUP_AXES), ascending."""
    mine = mesh_coords(rank, sizes)
    return [r for r in range(math.prod(sizes.values()))
            if all(c == mine[a] for a, c in mesh_coords(r, sizes).items()
                   if a not in GROUP_AXES[kind])]


def _mesh_groups(sizes: Dict[str, int]) -> Dict[str, object]:
    """This rank's process group of each kind of GROUP_AXES: None where it
    is this rank alone (nothing to communicate), the default group where it
    is every rank, else a subgroup. Made once for the default group: every
    rank makes every subgroup, in one order, as new_group requires."""
    key = (dist.group.WORLD,) + tuple(sizes[a] for a in MESH_AXES)
    if key not in _subgroups:
        world, rank = math.prod(sizes.values()), dist.get_rank()
        mine = {}
        for kind in GROUP_AXES:
            size = math.prod(sizes[a] for a in GROUP_AXES[kind])
            if size == 1:
                mine[kind] = None
                continue
            if size == world:
                mine[kind] = dist.group.WORLD
                continue
            seen = []
            for r in range(world):
                ranks = group_ranks(kind, r, sizes)
                if ranks in seen:
                    continue
                seen.append(ranks)
                group = dist.new_group(ranks)
                if rank in ranks:
                    mine[kind] = group
        _subgroups[key] = mine
    return _subgroups[key]


class DataParallel:
    """This process's place on the (data, fsdp, seq, tensor) mesh of the
    default process group and the collectives the port runs over it. The
    batch side: `rank` (the batch index b = d * F + f) and `world` (D * F),
    so batch index b holds rows b of W; `data`, `fsdp`, `seq` and `tensor`
    (the axes' sizes), `fsdp_index`, `seq_index`, `tensor_index`,
    `process_rank` (the rank in the process group), `replicas` (D * F * S,
    the ranks that hold one tensor index of the parameters) and `is_main`
    (process rank 0). Its groups (`tensor_group`, `seq_group`,
    `fsdp_group`, `data_group`, `replica_group`, `batch_group`; None where
    the group is this rank alone) are GROUP_AXES'. Collectives on host data
    run on `device` (the rank's current card under NCCL, the CPU under
    gloo)."""

    def __init__(self, fsdp: int = 1, fsdp_min_size: Optional[int] = None, seq: int = 1,
                 tensor: int = 1):
        self.process_rank = dist.get_rank()
        processes = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))
        self.fsdp, self.seq, self.tensor = fsdp, seq, tensor
        self.data = processes // (fsdp * seq * tensor)
        self.sizes = {DATA_AXIS: self.data, FSDP_AXIS: fsdp, SEQ_AXIS: seq, TENSOR_AXIS: tensor}
        coords = mesh_coords(self.process_rank, self.sizes)
        self.fsdp_index, self.seq_index = coords[FSDP_AXIS], coords[SEQ_AXIS]
        self.tensor_index = coords[TENSOR_AXIS]
        self.rank = coords[DATA_AXIS] * fsdp + self.fsdp_index
        self.world = self.data * fsdp
        self.replicas = self.world * seq
        self.fsdp_min_size = FSDP_MIN_SIZE if fsdp_min_size is None else fsdp_min_size
        groups = _mesh_groups(self.sizes)
        self.tensor_group, self.seq_group = groups["tensor"], groups["seq"]
        self.fsdp_group, self.data_group = groups["fsdp"], groups["data"]
        self.replica_group, self.batch_group = groups["replica"], groups["batch"]

    def __deepcopy__(self, memo):
        # a model that holds its mesh (SiT) is copied with the same groups
        return self

    @property
    def is_main(self) -> bool:
        return self.process_rank == 0

    def shard_plan(self, named_params, tp_rules: Sequence[tuple] = (),
                   sync_replicated: bool = False) -> Optional["ShardPlan"]:
        """The ShardPlan of `named_params` (name, tensor: this rank's tensor
        shards under `tp_rules`) on this mesh, or None where the fsdp and
        tensor axes are 1."""
        if self.fsdp > 1 or self.tensor > 1:
            return ShardPlan(self, named_params, tp_rules, sync_replicated)
        return None

    def all_reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the replica group of each gradient (the global
        batch's gradient: a seq rank's is S times its tokens' share,
        parallel/collectives.py), all-reduced in flat buckets of up to
        BUCKET_ELEMENTS (one dtype a bucket); returns views into the
        buckets, in the order given (the gradients themselves where the
        replica group is this rank alone)."""
        if self.replica_group is None:
            return list(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for part in _buckets([g.numel() for g in grads], [g.dtype for g in grads]):
            flat = torch.cat([grads[i].reshape(-1) for i in part])
            dist.all_reduce(flat, group=self.replica_group)
            flat.div_(self.replicas)
            for i, view in zip(part, torch.split(flat, [grads[i].numel() for i in part])):
                out[i] = view.view(grads[i].shape)
        return out

    def reduce_scatter(self, buf: torch.Tensor) -> torch.Tensor:
        """The sum over this rank's fsdp group of row `fsdp_index` of `buf`
        ([F, S], contiguous): [S]."""
        out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf.view(-1), group=self.fsdp_group)
        return out

    def all_gather(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank of the fsdp group's `row` ([S]), by fsdp index: [F, S]."""
        out = torch.empty((self.fsdp, row.numel()), dtype=row.dtype, device=row.device)
        dist.all_gather_into_tensor(out.view(-1), row, group=self.fsdp_group)
        return out

    def tensor_gather(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """Every rank of the tensor group's `shard`, by tensor index."""
        shard = shard.contiguous()
        out = torch.empty((self.tensor,) + tuple(shard.shape), dtype=shard.dtype,
                          device=shard.device)
        dist.all_gather_into_tensor(out.view(-1), shard.view(-1), group=self.tensor_group)
        return list(out.unbind())

    def _batch_sum(self, x: torch.Tensor):
        if self.batch_group is not None:
            dist.all_reduce(x, group=self.batch_group)

    def mean_metrics(self, metrics: Dict) -> Dict:
        """The tensor entries of `metrics` (scalars) averaged over the batch
        indices (the seq and tensor ranks of one hold the same) in one
        all-reduce on their device, with no host sync; other entries as
        they are."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        if not keys:
            return dict(metrics)
        flat = torch.stack([metrics[k].float().reshape(()) for k in keys])
        self._batch_sum(flat)
        flat.div_(self.world)
        return {**metrics, **dict(zip(keys, flat.unbind()))}

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of `x` over the batch indices (a new tensor, no gradient)."""
        x = x.detach().clone()
        self._batch_sum(x)
        return x

    def all_sum_host(self, x: np.ndarray) -> np.ndarray:
        """The sum over the batch indices of a host array, in f64."""
        t = torch.as_tensor(np.asarray(x, np.float64), device=self.device)
        self._batch_sum(t)
        return t.cpu().numpy()

    def rows(self, n: int) -> Tuple[int, int]:
        """(start, count) of this batch index's rows of a global batch of n
        rows split as np.array_split splits it (draws.split_rows): the
        first n mod W indices take one row more, and an index takes none
        where n < W."""
        starts, counts = split_rows(n, self.world)
        return int(starts[self.rank]), int(counts[self.rank])

    def take_rows(self, x, n: int):
        """This batch index's rows (`rows(n)`) of every tensor and array of
        n rows in `x` (nested dicts, lists and tuples; other leaves and 0-d
        arrays as they are)."""
        return _slice_rows(x, lambda _: self.rows(n))

    def gather_rows(self, x, total: Optional[int] = None):
        """Every batch index's rows `x` stacked in batch order (nested
        dicts, lists and tuples of tensors leaf by leaf). With `total` None
        the indices hold equal rows; with `total` they hold rows(total),
        and one with none passes None (the leaves' trailing shapes and
        dtypes then come from batch index 0, which holds rows wherever
        total > 0). Each rank writes its rows into a zeroed buffer of W x
        the largest share, one all-reduce (a sum) over the batch group
        fills it, and the padding is dropped: exactly the global rows,
        under NCCL and gloo alike."""
        if total is not None and total < self.world:
            x = self._like_index0(x, total)
        if isinstance(x, dict):
            return {k: self.gather_rows(v, total) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self.gather_rows(v, total) for v in x)
        n = x.shape[0] * self.world if total is None else total
        counts = split_rows(n, self.world)[1]
        if x.shape[0] != counts[self.rank]:
            raise ValueError(f"batch index {self.rank} holds {x.shape[0]} rows, its "
                             f"share of {n} is {counts[self.rank]}")
        wide = int(counts.max())
        flat = x.view(torch.uint8) if x.dtype == torch.bool else x
        full = torch.zeros((self.world, wide) + tuple(x.shape[1:]), dtype=flat.dtype,
                           device=x.device)
        full[self.rank, :x.shape[0]] = flat
        self._batch_sum(full)
        out = torch.cat([full[i, :int(c)] for i, c in enumerate(counts)])
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def _like_index0(self, x, total: int):
        """`x`, or where this batch index holds no rows of `total`, empty
        tensors in the structure, trailing shapes and dtypes of batch index
        0's (broadcast over the batch group)."""
        if total == 0:
            raise ValueError("a gather of no rows at all")
        src = group_ranks("batch", self.process_rank, self.sizes)[0]

        def skeleton(v):
            if isinstance(v, dict):
                return {k: skeleton(w) for k, w in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(skeleton(w) for w in v)
            return (tuple(v.shape[1:]), v.dtype, v.device.type)

        box = [skeleton(x) if self.process_rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.batch_group,
                                   device=self.device)
        if x is not None:
            return x

        def empty(v):
            if isinstance(v, dict):
                return {k: empty(w) for k, w in v.items()}
            if isinstance(v, list):
                return [empty(w) for w in v]
            if isinstance(v, tuple) and not (len(v) == 3 and isinstance(v[1], torch.dtype)):
                return tuple(empty(w) for w in v)
            device = (torch.device("cuda", torch.cuda.current_device()) if v[2] == "cuda"
                      else torch.device(v[2]))
            return torch.empty((0,) + v[0], dtype=v[1], device=device)

        return empty(box[0])

    def barrier(self):
        dist.barrier()


class _GatherChunks(torch.autograd.Function):
    """A unit's parameters (ShardPlan.units) gathered whole from this rank's
    chunks inside the autograd graph. Forward: each chunk cast to the
    unit's gather dtype (the dtype the model computes the unit in: the cast
    is elementwise, so the gathered cast is the cast of the gathered
    parameter, in fewer bytes under bf16), then all-gathered over the fsdp
    group into the whole tensors (this rank's tensor shards, contiguous).
    Backward: the whole gradients cast to the parameters' dtype (what the
    cast's own backward gives them), reduce-scattered over the fsdp group,
    all-reduced over the data group and divided by the replicas
    (ShardPlan.reduce_unit): each chunk's gradient is the replica group's
    mean, as the step's autograd.grad hands it over."""

    @staticmethod
    def forward(ctx, plan, k, dtype, *chunks):
        ctx.plan, ctx.k = plan, k
        return plan.gather_unit(k, chunks, dtype)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(ctx.plan.reduce_unit(ctx.k, grads))


def _unit_hooks(plan: "ShardPlan", k: int, module: nn.Module):
    """Forward hooks that gather unit `k` whole around `module`'s forward.
    They act on `module` alone: a deep copy of the model keeps the hooks but
    gathers nothing (whole_copy). They hold the plan, which holds the
    model's modules weakly, so no reference cycle keeps a model alive."""
    def enter(mod, args):
        if plan._unit_module(k) is mod:
            plan._enter(k)

    def leave(mod, args, out):
        if plan._unit_module(k) is mod:
            plan._leave(k)

    module.register_forward_pre_hook(enter)
    module.register_forward_hook(leave, always_call=True)


class ShardPlan:
    """Which of a model's parameters the tensor and fsdp axes shard, and the
    collectives over them. `named_params` are this rank's: the tensor shards
    of the parameters `tp_rules` name (`tensor[i]`, its (dimension, groups),
    None where replicated over tensor). The fsdp axis shards a parameter
    where reed_tpu's rule (`fsdp_spec` of the whole shape with the mesh's
    fsdp_min_size, the tensor rule's dimension taken) does (`sharded[i]`):
    its tensor shard of n elements is owned in F flat chunks of n / F
    (fsdp_spec only shards a leaf with another dimension divisible by F);
    `local` gives this rank's chunk of a tensor in the shard's shape (as a
    view) or of a chunk (itself). State lists (gradients, moments, EMA) are
    in parameter order, chunks where `sharded`.

    `attach` shards the model at rest: its sharded parameters become their
    chunks, gathered a unit at a time where the model reads them (`units`,
    `_GatherChunks`), so the sharded leaves' gradients leave autograd
    already reduced and `reduce_grads` reduces the rest. Code that reads the
    parameters outside the train step takes them whole through
    `whole_params` or `whole_copy`.

    `sync_replicated`: average the gradients of the leaves replicated over
    the tensor axis over the tensor group too (reduce_grads, reduce_unit).
    Every tensor rank computes those gradients from the same inputs, so they
    agree where the computation is deterministic (SiT's is: phase 15 holds
    its ranks' parameters bitwise equal); a model whose replicated path runs
    CUDA atomics (ProteinMPNN's neighbour gathers, whose backward is a
    scatter_add) gets them apart in the last bits, and the average keeps
    the ranks' copies of its replicated parameters bitwise equal."""

    def __init__(self, dp: DataParallel, named_params, tp_rules: Sequence[tuple] = (),
                 sync_replicated: bool = False):
        self.dp = dp
        named = list(named_params)
        tensor = getattr(dp, "tensor", 1)
        self.names = [n for n, _ in named]
        self.tp_rules = tuple(tp_rules)
        self.sync_replicated = sync_replicated and tensor > 1
        self.shapes = [tuple(p.shape) for _, p in named]
        self.dtypes = [p.dtype for _, p in named]
        self.tensor = [tensor_rule(n, tp_rules) if tensor > 1 else None for n in self.names]
        self.whole_shapes = [
            shape if rule is None else
            shape[:rule[0]] + (shape[rule[0]] * tensor,) + shape[rule[0] + 1:]
            for shape, rule in zip(self.shapes, self.tensor)]
        self.sharded = [
            fsdp_spec(shape, dp.fsdp, dp.fsdp_min_size,
                      taken=None if rule is None else rule[0]) is not None
            for shape, rule in zip(self.whole_shapes, self.tensor)]
        self.index = {n: i for i, n in enumerate(self.names)}
        # set by attach: (module, attribute) of each parameter, the units
        # (modules held weakly), each unit's chunks while it is gathered, the
        # rest's unit
        self._slots: Optional[List[Tuple[weakref.ref, str]]] = None
        self._units: List[Tuple[List[int], Optional[torch.dtype], Optional[weakref.ref]]] = []
        self._live: List[Optional[list]] = []
        self._rest: Optional[int] = None
        self._whole = False

    @property
    def any_sharded(self) -> bool:
        return any(self.sharded)

    @property
    def any_tensor(self) -> bool:
        return any(r is not None for r in self.tensor)

    def chunk_size(self, i: int) -> int:
        return math.prod(self.shapes[i]) // self.dp.fsdp

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of tensor `t` of parameter `i`: a view of `t` in
        the parameter's shape, `t` itself where it is the chunk already (a
        sharded parameter has 2 dimensions or more, its chunk one) or the
        parameter is replicated over fsdp."""
        if not self.sharded[i] or t.dim() == 1:
            return t
        n = self.chunk_size(i)
        return t.view(-1)[self.dp.fsdp_index * n:(self.dp.fsdp_index + 1) * n]

    def local_named(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.local(self.index[name], t)

    def tensor_local(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's tensor shard of a whole tensor of parameter `i`."""
        if whole.shape != self.whole_shapes[i]:
            raise ValueError(f"{self.names[i]}: {tuple(whole.shape)}, the whole parameter "
                             f"is {self.whole_shapes[i]}")
        if self.tensor[i] is None:
            return whole
        return tensor_split(whole, self.tensor[i], self.dp.tensor, self.dp.tensor_index)

    def share(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's share of a whole tensor of parameter `i`: the fsdp
        chunk of its tensor shard."""
        return self.local(i, self.tensor_local(i, whole).contiguous())

    def share_state_dict(self, whole: Mapping) -> Dict[str, torch.Tensor]:
        """This rank's share of a whole state_dict of the model: each
        parameter's share, other entries (buffers) as they are."""
        out = dict(whole)
        out.update((n, self.share(i, whole[n])) for i, n in enumerate(self.names))
        return out

    def resident_elements(self) -> int:
        """Elements of one copy of the state a rank holds (the parameters,
        the EMA, mu, nu, acc): the chunks of the fsdp-sharded parameters and
        the rest of its tensor shards."""
        return sum(self.chunk_size(i) if s else math.prod(self.shapes[i])
                   for i, s in enumerate(self.sharded))

    # --- the parameters sharded at rest -------------------------------------

    def units(self, model: nn.Module
              ) -> List[Tuple[List[int], Optional[torch.dtype], Optional[nn.Module]]]:
        """The groups of sharded parameters gathered together, as (parameter
        indices, gather dtype, module): one for each module that
        `model.fsdp_units()` names with the dtype it computes in (SiT: each
        block; None: the parameters' dtype), gathered around that module's
        forward, then the rest of the model's in one (module None, the
        parameters' dtype), gathered around the train step's loss
        (`gathered`). reed_tpu has no units (XLA schedules its gathers):
        the grouping sets what is whole at once, never the numbers."""
        named = list(model.fsdp_units()) if hasattr(model, "fsdp_units") else []
        prefix = {id(m): n for n, m in model.named_modules()}
        out, taken = [], set()
        for module, dtype in named:
            start = prefix[id(module)] + "."
            idx = [i for i, n in enumerate(self.names) if self.sharded[i] and n.startswith(start)]
            taken.update(idx)
            out.append((idx, dtype, module))
        out.append(([i for i, s in enumerate(self.sharded) if s and i not in taken], None, None))
        return [u for u in out if u[0]]

    def attach(self, model: nn.Module) -> nn.Module:
        """Shard `model` (whose named_parameters the plan was made of) at
        rest: each sharded parameter becomes a parameter of this rank's
        chunk alone (the whole tensor is freed), what the optimizer, the EMA
        and autograd.grad see. Each of `units` is gathered where the model
        reads it: a named module's around its forward (forward hooks, which
        a checkpointed module's recompute runs again, so remat gathers
        afresh instead of keeping the whole weights), the rest around the
        train step's loss (`gathered`). Returns `model`."""
        if [n for n, _ in model.named_parameters()] != self.names:
            raise ValueError("the model's parameters are not the ones the plan was made of")
        self._slots = []
        for name in self.names:
            module, _, leaf = name.rpartition(".")
            self._slots.append((weakref.ref(model.get_submodule(module)), leaf))
        with torch.no_grad():
            for i, p in enumerate(self._params()):
                if self.sharded[i]:
                    self._install([i], [nn.Parameter(self.local(i, p.detach()).clone(),
                                                     requires_grad=p.requires_grad)])
        units = self.units(model)
        self._units = [(idx, dtype, None if m is None else weakref.ref(m))
                       for idx, dtype, m in units]
        self._live = [None] * len(units)
        for k, (idx, _, module) in enumerate(units):
            if len({self.dtypes[i] for i in idx}) > 1:
                raise ValueError("a unit's parameters must share one dtype")
            if module is None:
                self._rest = k
            else:
                _unit_hooks(self, k, module)
        return model

    def _unit_module(self, k: int) -> Optional[nn.Module]:
        ref = self._units[k][2]
        return None if ref is None else ref()

    def _params(self, idx: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """What the model holds for parameters `idx` (default all)."""
        idx = range(len(self.names)) if idx is None else idx
        return [self._slots[i][0]()._parameters[self._slots[i][1]] for i in idx]

    def _install(self, idx: Sequence[int], tensors: Sequence[torch.Tensor]):
        for i, t in zip(idx, tensors):
            module, leaf = self._slots[i]
            module()._parameters[leaf] = t

    def _enter(self, k: int):
        """Put unit k's parameters, gathered whole by _GatherChunks, in place
        of their chunks (nothing where they are whole already)."""
        idx, dtype, _ = self._units[k]
        if self._whole or self._live[k] is not None:
            return
        chunks = self._params(idx)
        self._live[k] = chunks
        self._install(idx, _GatherChunks.apply(self, k, dtype, *chunks))

    def _leave(self, k: int):
        """Put unit k's chunks back."""
        if self._live[k] is not None:
            self._install(self._units[k][0], self._live[k])
            self._live[k] = None

    @contextlib.contextmanager
    def gathered(self):
        """The rest of the attached model (the unit no module names) whole
        inside the block: the train step's loss."""
        if self._rest is None:
            yield
            return
        self._enter(self._rest)
        try:
            yield
        finally:
            self._leave(self._rest)

    def gather_unit(self, k: int, chunks: Sequence[torch.Tensor],
                    dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, ...]:
        """_GatherChunks' forward: unit k's whole tensors from its `chunks`,
        cast to `dtype` (None: as they are) and all-gathered in one flat
        buffer [F, S], each then copied out contiguous."""
        idx = self._units[k][0]
        full = self.dp.all_gather(torch.cat([c.reshape(-1) if dtype is None else
                                             c.reshape(-1).to(dtype) for c in chunks]))
        out, off = [], 0
        for i in idx:
            n = self.chunk_size(i)
            out.append(full[:, off:off + n].reshape(self.shapes[i]))
            off += n
        return tuple(out)

    def reduce_unit(self, k: int, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """_GatherChunks' backward: the chunk gradients of unit k from its
        whole gradients `grads`, cast to the parameters' dtype, the mean
        over the replica group (reduce-scattered over the fsdp group in one
        flat buffer, all-reduced over the data group, divided by D * F * S;
        with sync_replicated, those of leaves replicated over the tensor
        axis then averaged over the tensor group)."""
        dp, idx = self.dp, self._units[k][0]
        dtype = self.dtypes[idx[0]]
        mine = dp.reduce_scatter(torch.cat([g.to(dtype).reshape(dp.fsdp, -1) for g in grads],
                                           dim=1))
        if dp.data_group is not None:
            dist.all_reduce(mine, group=dp.data_group)
        out = list(torch.split(mine.div(dp.replicas), [self.chunk_size(i) for i in idx]))
        rep = [j for j, i in enumerate(idx) if self.tensor[i] is None]
        if self.sync_replicated and rep:
            flat = torch.cat([out[j] for j in rep])
            dist.all_reduce(flat, group=dp.tensor_group)
            flat.div_(dp.tensor)
            for j, view in zip(rep, torch.split(flat, [out[j].numel() for j in rep])):
                out[j] = view
        return out

    @contextlib.contextmanager
    def whole_params(self, write: bool = False):
        """Every parameter of the attached model whole (its tensor shards)
        inside the block, gathered without autograd: for code that reads
        them outside the train step (sampling in training, state_dict(), a
        warm start's load_state_dict). With `write` the chunks are then
        taken from the whole tensors, so what the block wrote into them
        stays. A collective (nothing where the plan is not attached)."""
        if self._slots is None or self._whole:
            yield
            return
        idx = [i for i, s in enumerate(self.sharded) if s]
        params = self._params()
        chunks = [params[i] for i in idx]
        with torch.no_grad():
            wholes = self.gather(params)
        self._install(idx, [nn.Parameter(wholes[i], requires_grad=c.requires_grad)
                            for i, c in zip(idx, chunks)])
        self._whole = True
        try:
            yield
            if write:
                with torch.no_grad():
                    for i, c, w in zip(idx, chunks, self._params(idx)):
                        c.copy_(self.local(i, w))
        finally:
            self._whole = False
            self._install(idx, chunks)

    # --- the collectives of the state lists ----------------------------------

    def _sharded_buckets(self, dtypes) -> List[List[int]]:
        idx = [i for i, s in enumerate(self.sharded) if s]
        parts = _buckets([self.chunk_size(i) * self.dp.fsdp for i in idx],
                         [dtypes[i] for i in idx])
        return [[idx[j] for j in part] for part in parts]

    def reduce_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the replica group of each gradient in `grads`, as
        this rank keeps it: the gradients of the fsdp-sharded parameters
        (chunks) as they are, since their units' _GatherChunks reduced them
        in autograd, and the whole of the rest through the replica group's
        bucketed all-reduce; with sync_replicated, those of the rest that
        are replicated over the tensor axis then averaged over the tensor
        group."""
        dp = self.dp
        out = list(grads)
        repl = [i for i, s in enumerate(self.sharded) if not s]
        for i, g in zip(repl, dp.all_reduce_grads([grads[i] for i in repl])):
            out[i] = g
        if self.sync_replicated:
            repl = [i for i in repl if self.tensor[i] is None]
            for part in _buckets([out[i].numel() for i in repl], [out[i].dtype for i in repl]):
                idx = [repl[j] for j in part]
                flat = torch.cat([out[i].reshape(-1) for i in idx])
                dist.all_reduce(flat, group=dp.tensor_group)
                flat.div_(dp.tensor)
                for i, view in zip(idx, torch.split(flat, [out[i].numel() for i in idx])):
                    out[i] = view.view(out[i].shape)
        return out

    def _gather_whole(self, chunks: Sequence[torch.Tensor]):
        """(part, [F, S]) for each bucket of the sharded entries of `chunks`:
        the part's chunks all-gathered over the fsdp group, bit for bit."""
        for part in self._sharded_buckets([t.dtype for t in chunks]):
            yield part, self.dp.all_gather(torch.cat([chunks[i] for i in part]))

    def gather(self, tensors: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """The tensors of a state list in the parameters' shapes on this rank
        (its tensor shards), the chunks gathered over the fsdp group bit for
        bit; entries replicated over fsdp as they are. A collective: every
        rank of the group calls it."""
        out = list(tensors)
        for part, full in self._gather_whole(tensors):
            off = 0
            for i in part:
                n = self.chunk_size(i)
                out[i] = full[:, off:off + n].reshape(self.shapes[i])
                off += n
        return out

    def join(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of a list in the parameters' shapes on this rank
        (its tensor shards), joined over the tensor group (a collective)."""
        return [t if rule is None else tensor_join(self.dp.tensor_gather(t), rule)
                for t, rule in zip(tensors, self.tensor)]

    def whole(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of a state list: `gather`, then `join`."""
        return self.join(self.gather(tensors))

    def gather_named(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`gather` of a state dict keyed by parameter name (the EMA)."""
        return dict(zip(self.names, self.gather([state[n] for n in self.names])))

    def whole_named(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`whole` of a state dict keyed by parameter name (the EMA)."""
        return dict(zip(self.names, self.whole([state[n] for n in self.names])))

    def join_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The model's whole state_dict from this rank's: the parameters'
        chunks gathered over the fsdp group and their tensor shards joined,
        other entries (buffers) as they are."""
        out = dict(state_dict)
        out.update(zip(self.names, self.whole([state_dict[n] for n in self.names])))
        return out

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's `grads`:
        the squares of the fsdp chunks summed over the fsdp group, then
        those of the tensor shards over the tensor group, those of the
        replicated leaves added once."""
        def sq(keep):
            g = [g for i, g in enumerate(grads) if keep(i)]
            return (torch.stack(torch._foreach_norm(g)).square().sum() if g
                    else grads[0].new_zeros((), dtype=torch.float32))

        chunks = torch.stack([sq(lambda i: self.sharded[i] and self.tensor[i] is None),
                              sq(lambda i: self.sharded[i] and self.tensor[i] is not None)])
        if self.dp.fsdp > 1:
            dist.all_reduce(chunks, group=self.dp.fsdp_group)
        tp = chunks[1] + sq(lambda i: not self.sharded[i] and self.tensor[i] is not None)
        if self.dp.tensor > 1:
            dist.all_reduce(tp, group=self.dp.tensor_group)
        return (chunks[0] + sq(lambda i: not self.sharded[i] and self.tensor[i] is None)
                + tp).sqrt()


def whole_params(plan: Optional[ShardPlan], write: bool = False):
    """plan.whole_params(write): its model's parameters whole inside the
    block; nothing to do where `plan` is None."""
    return contextlib.nullcontext() if plan is None else plan.whole_params(write)


def whole_copy(model: nn.Module, plan: Optional[ShardPlan] = None) -> nn.Module:
    """A deep copy of `model` with whole parameters (its tensor shards;
    gathered where `plan` holds them sharded at rest, a collective) that
    gathers nothing itself: the EMA models and samplers of training."""
    with whole_params(plan):
        return copy.deepcopy(model)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None):
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK in the environment): NCCL on `cuda` (the device becomes
    cuda:LOCAL_RANK, made the current device) and gloo on `cpu`, unless
    `backend` names another; the rendezvous is torchrun's (env://) unless
    `init_method` names one (file://path). Returns (device, DataParallel).
    Raises when the environment, the device, the backend or the
    rendezvous is missing; a group already joined is reused."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs {', '.join(missing)} in the environment: launch "
            "with torchrun --nproc_per_node N -m reed_tpu_torch.cli ... --distributed")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError(f"the process group holds rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, the environment says {rank} "
                               f"of {world}")
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return device, DataParallel()


def data_parallel(mesh=None, batch_size: Optional[int] = None,
                  axes: Sequence[str] = ()) -> Optional[DataParallel]:
    """The context of the default process group on `mesh`'s axes, carrying
    its fsdp size and min size (the rule of its ShardPlan), or None when
    there is no group (one process, no collectives), after `check_mesh` of
    `mesh` and the global `batch_size` against its world size (`axes`: the
    model axes the family runs: SIT_AXES, PMPNN_AXES, SEMLA_AXES,
    EGNN_AXES, IPA_AXES or RDM_AXES)."""
    mesh = MeshConfig() if mesh is None else mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    _, fsdp = check_mesh(mesh, world, batch_size, axes)
    if not dist.is_initialized():
        return None
    return DataParallel(fsdp, mesh.fsdp_min_size, mesh.seq or 1, mesh.tensor or 1)
