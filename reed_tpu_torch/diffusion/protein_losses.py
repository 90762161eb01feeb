"""Protein inverse-folding losses: NLL, label-smoothed CE, and the triple
(single/pair/structure) representation-alignment loss.

Counterpart of reed_tpu/diffusion/protein_losses.py (reference:
protein/fmif/model_utils.py:167-251). The pair target is gathered along the
k-NN edges with an indexed gather, where reed_tpu uses a one-hot einsum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from reed_tpu_torch.data.protein import NUM_TOKENS
from reed_tpu_torch.ops.graph import gather_edges, gather_nodes


def loss_nll(s, log_probs, mask):
    """Per-token NLL, its masked average and the argmax-accuracy indicator
    (reference: model_utils.py:167-176)."""
    loss = -torch.gather(log_probs, -1, s.long()[..., None])[..., 0]
    true_false = (s == torch.argmax(log_probs, dim=-1)).float()
    loss_av = torch.sum(loss * mask) / torch.sum(mask)
    return loss, loss_av, true_false


def loss_smoothed(s, log_probs, mask, weight: float = 0.1, t=None,
                  t_schedule: bool = False):
    """Label-smoothed CE with the reference's fixed /2000 token normalizer and
    the optional 1/(1-t) time schedule (reference: model_utils.py:179-193)."""
    s_onehot = (s.long()[..., None] == torch.arange(NUM_TOKENS, device=s.device)).float()
    s_onehot = s_onehot + weight / NUM_TOKENS
    s_onehot = s_onehot / torch.sum(s_onehot, dim=-1, keepdim=True)
    loss = -torch.sum(s_onehot * log_probs, dim=-1)
    if t_schedule:
        if t is None:
            raise ValueError("loss_smoothed: t_schedule needs t")
        loss = loss / (1.0 - t) / 4.605  # log(0.01) = -4.605; t: [B,1]
    loss_av = torch.sum(loss * mask) / 2000.0
    return loss, loss_av


def _masked_mean_std(x, mask, dims):
    """As reed_tpu computes it: the variance sums (x * mask - mean)^2 over
    the masked-out positions too (a quirk kept for parity)."""
    mean = torch.sum(x * mask, dim=dims, keepdim=True) / torch.sum(mask)
    var = torch.sum((x * mask - mean) ** 2, dim=dims, keepdim=True) / torch.sum(mask)
    return mean, torch.sqrt(var)


def _l2norm(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def loss_repr(repr_single, repr_pair, repr_structure,
              zs_single, zs_pair, zs_structure,
              e_idx, mask, mask_residue, generator: Optional[torch.Generator] = None,
              repr_norm: bool = False, repr_noise: float = 0.0,
              noise: Optional[Sequence[torch.Tensor]] = None):
    """Triple cosine alignment loss, unmasked and masked-residue variants
    (reference: model_utils.py:196-251).

    repr_pair [B,L,L,z] full pair embeddings (gathered here along e_idx),
    zs_pair [B,L,K,z] projected decoder edge activations; the structure
    target is scaled by 1/100 as in the reference. With repr_noise > 0 the
    normalised targets get repr_noise * N(0, 1) noise, drawn from
    `generator` unless `noise` (three tensors shaped like the single,
    gathered pair and structure targets) is given. Returns (single, pair,
    structure, single_m, pair_m, structure_m)."""
    repr_single = repr_single.float()
    repr_pair = repr_pair.float()
    repr_structure = repr_structure.float() / 100.0

    b, l, _, z = repr_pair.shape
    repr_pair = gather_edges(repr_pair, e_idx)  # [B,L,K,z]
    mask_pair = mask[:, :, None] * gather_nodes(mask[..., None], e_idx)[..., 0]
    mask_pair_residue = mask_residue[:, :, None] * mask_pair

    if repr_norm:
        m, s = _masked_mean_std(repr_single, mask[..., None], (0, 1))
        repr_single = (repr_single - m) / (s + 1e-6)
        m, s = _masked_mean_std(repr_pair, mask_pair[..., None], (0, 1, 2))
        repr_pair = (repr_pair - m) / (s + 1e-6)
        m, s = _masked_mean_std(repr_structure, mask[..., None], (0, 1))
        repr_structure = (repr_structure - m) / (s + 1e-6)

    if repr_noise > 0.0:
        targets = (repr_single, repr_pair, repr_structure)
        if noise is None:
            noise = [torch.randn(x.shape, generator=generator, device=x.device)
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

    loss_single = -torch.sum(sim_single * mask) / torch.sum(mask)
    loss_pair = -torch.sum(sim_pair * mask_pair.reshape(b, -1)) / torch.sum(mask_pair)
    loss_structure = -torch.sum(sim_structure * mask) / torch.sum(mask)
    loss_single_m = -torch.sum(sim_single * mask_residue) / torch.sum(mask_residue)
    loss_pair_m = (-torch.sum(sim_pair * mask_pair_residue.reshape(b, -1))
                   / torch.sum(mask_pair_residue))
    loss_structure_m = -torch.sum(sim_structure * mask_residue) / torch.sum(mask_residue)
    return (loss_single, loss_pair, loss_structure,
            loss_single_m, loss_pair_m, loss_structure_m)
