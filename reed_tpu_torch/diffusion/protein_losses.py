"""Protein inverse-folding losses: NLL, label-smoothed CE, and the triple
(single/pair/structure) representation-alignment loss.

Counterpart of reed_tpu/diffusion/protein_losses.py (reference:
protein/fmif/model_utils.py:167-251). The pair target is gathered along the
k-NN edges with an indexed gather, where reed_tpu uses a one-hot einsum.

Data parallel (`dp`, a parallel.mesh.DataParallel over a rank's rows of
the global batch): these losses are normalised by counts over the batch
(token and pair masks, the fixed /2000) and repr_norm standardises the
targets over the whole batch, so each rank takes the global sums and
counts, all-reduced, and scales its share so that the mean over the ranks
of its loss, and of its gradient, is the global batch's (reed_tpu's one jit
over the global batch). The seq and tensor ranks of one batch index hold
the same rows and compute the same losses; the sums run over the batch
group (one rank a batch index), so no count is taken T times, and the
alignment losses read the projectors' outputs after the tensor group's
reduce (models/pmpnn.py), whole on every rank. With dp None every
expression is the one-process one, bitwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from reed_tpu_torch.data.protein import NUM_TOKENS
from reed_tpu_torch.ops.graph import gather_edges, gather_nodes
from reed_tpu_torch.parallel import draws


def global_counts(dp, *xs):
    """sum(x) of each of `xs`, over the global batch divided by the world
    size where `dp` is given (one all-reduce): a rank's sum over it is then
    its share of the global mean."""
    totals = torch.stack([torch.sum(x) for x in xs])
    if dp is not None:
        totals = dp.all_sum(totals) / dp.world
    return totals.unbind()


def loss_nll(s, log_probs, mask, count=None):
    """Per-token NLL, its masked average and the argmax-accuracy indicator
    (reference: model_utils.py:167-176). The average divides by `count`,
    sum(mask) unless given (global_counts' share of the global batch's)."""
    loss = -torch.gather(log_probs, -1, s.long()[..., None])[..., 0]
    true_false = (s == torch.argmax(log_probs, dim=-1)).float()
    loss_av = torch.sum(loss * mask) / (torch.sum(mask) if count is None else count)
    return loss, loss_av, true_false


def loss_smoothed(s, log_probs, mask, weight: float = 0.1, t=None,
                  t_schedule: bool = False, dp=None):
    """Label-smoothed CE with the reference's fixed /2000 token normalizer
    (over the global batch) and the optional 1/(1-t) time schedule
    (reference: model_utils.py:179-193)."""
    s_onehot = (s.long()[..., None] == torch.arange(NUM_TOKENS, device=s.device)).float()
    s_onehot = s_onehot + weight / NUM_TOKENS
    s_onehot = s_onehot / torch.sum(s_onehot, dim=-1, keepdim=True)
    loss = -torch.sum(s_onehot * log_probs, dim=-1)
    if t_schedule:
        if t is None:
            raise ValueError("loss_smoothed: t_schedule needs t")
        loss = loss / (1.0 - t) / 4.605  # log(0.01) = -4.605; t: [B,1]
    loss_av = torch.sum(loss * mask) / (2000.0 if dp is None else 2000.0 / dp.world)
    return loss, loss_av


def _masked_mean_std(x, mask, dims, dp=None):
    """As reed_tpu computes it, over the global batch (`dims` include the
    batch axis): the variance sums (x * mask - mean)^2 over the masked-out
    positions too (a quirk kept for parity)."""
    def total(y):
        y = torch.sum(y, dim=dims, keepdim=True)
        return y if dp is None else dp.all_sum(y)

    count = torch.sum(mask) if dp is None else dp.all_sum(torch.sum(mask))
    mean = total(x * mask) / count
    var = total((x * mask - mean) ** 2) / count
    return mean, torch.sqrt(var)


def _l2norm(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def loss_repr(repr_single, repr_pair, repr_structure,
              zs_single, zs_pair, zs_structure,
              e_idx, mask, mask_residue, generator: Optional[torch.Generator] = None,
              repr_norm: bool = False, repr_noise: float = 0.0,
              noise: Optional[Sequence[torch.Tensor]] = None, dp=None):
    """Triple cosine alignment loss, unmasked and masked-residue variants
    (reference: model_utils.py:196-251).

    repr_pair [B,L,L,z] full pair embeddings (gathered here along e_idx),
    zs_pair [B,L,K,z] projected decoder edge activations; the structure
    target is scaled by 1/100 as in the reference. With repr_noise > 0 the
    normalised targets get repr_noise * N(0, 1) noise, drawn from
    `generator` unless `noise` (three tensors shaped like the single,
    gathered pair and structure targets) is given. Returns (single, pair,
    structure, single_m, pair_m, structure_m), each normalised over the
    global batch under `dp`."""
    repr_single = repr_single.float()
    repr_pair = repr_pair.float()
    repr_structure = repr_structure.float() / 100.0

    b, l, _, z = repr_pair.shape
    repr_pair = gather_edges(repr_pair, e_idx)  # [B,L,K,z]
    mask_pair = mask[:, :, None] * gather_nodes(mask[..., None], e_idx)[..., 0]
    mask_pair_residue = mask_residue[:, :, None] * mask_pair

    if repr_norm:
        m, s = _masked_mean_std(repr_single, mask[..., None], (0, 1), dp)
        repr_single = (repr_single - m) / (s + 1e-6)
        m, s = _masked_mean_std(repr_pair, mask_pair[..., None], (0, 1, 2), dp)
        repr_pair = (repr_pair - m) / (s + 1e-6)
        m, s = _masked_mean_std(repr_structure, mask[..., None], (0, 1), dp)
        repr_structure = (repr_structure - m) / (s + 1e-6)

    if repr_noise > 0.0:
        targets = (repr_single, repr_pair, repr_structure)
        if noise is None:
            noise = [draws.randn(x.shape, generator=generator, device=x.device)
                     for x in targets]
        repr_single, repr_pair, repr_structure = (
            x + repr_noise * n.to(x.device, torch.float32) for x, n in zip(targets, noise))

    repr_single = _l2norm(repr_single)
    repr_pair = _l2norm(repr_pair.reshape(b, -1, z))
    repr_structure = _l2norm(repr_structure)
    zs_single = _l2norm(zs_single.float())
    zs_pair = _l2norm(zs_pair.float().reshape(b, -1, z))
    zs_structure = _l2norm(zs_structure.float())

    sim_single = torch.sum(repr_single * zs_single, dim=-1)          # [B,L]
    sim_pair = torch.sum(repr_pair * zs_pair, dim=-1)                # [B,L*K]
    sim_structure = torch.sum(repr_structure * zs_structure, dim=-1)

    n_mask, n_pair, n_residue, n_pair_residue = global_counts(
        dp, mask, mask_pair, mask_residue, mask_pair_residue)
    loss_single = -torch.sum(sim_single * mask) / n_mask
    loss_pair = -torch.sum(sim_pair * mask_pair.reshape(b, -1)) / n_pair
    loss_structure = -torch.sum(sim_structure * mask) / n_mask
    loss_single_m = -torch.sum(sim_single * mask_residue) / n_residue
    loss_pair_m = -torch.sum(sim_pair * mask_pair_residue.reshape(b, -1)) / n_pair_residue
    loss_structure_m = -torch.sum(sim_structure * mask_residue) / n_residue
    return (loss_single, loss_pair, loss_structure,
            loss_single_m, loss_pair_m, loss_structure_m)
