"""Shared pieces of the reed_tpu_torch parity tests (tests/test_torch_*.py):
a tiny SiT and a tiny ProteinMPNN-FMIF, each built in both frameworks with
the same random weights.

Every parameter is drawn from a seeded normal: SiT zero-initialises
adaLN_modulation and final_layer, and at init the attention output never
reaches the velocity; ProteinMPNN-FMIF zero-initialises node_embeds, which
hides the start of the encoder. A test at init would prove nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from reed_tpu.models.pmpnn import ProteinMPNNFMIF as JaxFMIF
from reed_tpu.models.sit import SiT as JaxSiT
from reed_tpu_torch.encoders import fmif_convert
from reed_tpu_torch.encoders.sit_convert import state_dict_from_flax
from reed_tpu_torch.models.pmpnn import ProteinMPNNFMIF
from reed_tpu_torch.models.sit import SiT

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
            depth=2, num_heads=4, num_classes=10, encoder_depth=1,
            z_dims=(8,), projector_dim=32)


def random_params(jax_model, std=0.02, seed=0):
    """A numpy param tree of `jax_model` with every leaf ~ N(0, std)."""
    x = jnp.zeros((1, jax_model.input_size, jax_model.input_size,
                   jax_model.in_channels))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1,)), jnp.zeros((1,), jnp.int32),
        return_zs=True))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def tiny_pair(std=0.02, seed=0, **overrides):
    """(jax SiT, its numpy variables, port SiT with the same weights)."""
    kw = dict(TINY, **overrides)
    jax_model = JaxSiT(**kw)
    variables = random_params(jax_model, std=std, seed=seed)
    model = SiT(**kw).eval()
    model.load_state_dict(state_dict_from_flax(variables, kw["patch_size"]))
    return jax_model, variables, model


def tiny_inputs(batch=3, seed=1, **overrides):
    """Numpy (x NHWC, t, y) for the tiny SiT; y includes the null class."""
    kw = dict(TINY, **overrides)
    rng = np.random.default_rng(seed)
    size, c = kw["input_size"], kw["in_channels"]
    x = rng.standard_normal((batch, size, size, c)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, batch).astype(np.float32)
    y = rng.integers(0, kw["num_classes"] + 1, batch).astype(np.int32)
    return x, t, y


FMIF_TINY = dict(hidden_dim=32, edge_features=32, num_encoder_layers=2,
                 num_decoder_layers=2, k_neighbors=4, single_dim=16, pair_dim=8,
                 structure_dim=16)


def fmif_batch(batch=2, length=14, pad=0, seed=1):
    """Numpy batch of the featurize() schema: a random-walk backbone, random
    tokens; the last `pad` positions of each chain are padding (zero
    coordinates, token X, mask 0, residue index -100)."""
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((batch, length, 3)) * 1.5
    ca = np.cumsum(steps, 1) + 3.8 * np.arange(length)[None, :, None] * [1.0, 0, 0]
    offsets = np.array([[-1.46, 0, 0], [0, 0, 0], [1.52, 0, 0], [2.4, 1.0, 0]])
    x = (ca[:, :, None, :] + offsets[None, None]).astype(np.float32)
    s = rng.integers(0, 20, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.float32)
    residue_idx = np.tile(np.arange(length, dtype=np.int32), (batch, 1))
    if pad:
        x[:, -pad:] = 0.0
        s[:, -pad:] = 20
        mask[:, -pad:] = 0.0
        residue_idx[:, -pad:] = -100
    return {"X": x, "S": s, "mask": mask, "chain_M": np.ones_like(mask),
            "residue_idx": residue_idx,
            "chain_encoding_all": np.zeros((batch, length), np.int32)}


def fmif_args(batch, s=None):
    """The model's positional arguments (numpy), tokens replaced by `s`."""
    return (batch["X"], batch["S"] if s is None else s, batch["mask"],
            batch["chain_M"], batch["residue_idx"], batch["chain_encoding_all"])


def fmif_random_params(jax_model, batch, std=0.1, seed=0, cls=None):
    """A numpy param tree of `jax_model`, every leaf ~ N(0, std) and every
    LayerNorm scale ~ 1 + N(0, std)."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), *fmif_args(batch), cls=cls, return_rep=True))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = (rng.standard_normal(s.shape) * std).astype(np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tiny_fmif_pair(batch, std=0.1, seed=0, cls=None, **overrides):
    """(jax ProteinMPNNFMIF, its numpy variables, port model with the same
    weights). `overrides` apply to both models (fused, use_cfg, ...)."""
    kw = dict(FMIF_TINY, **overrides)
    jax_model = JaxFMIF(augment_eps=0.0, dropout=0.0, **kw)
    variables = fmif_random_params(jax_model, batch, std=std, seed=seed, cls=cls)
    model = ProteinMPNNFMIF(**kw).eval()
    model.load_state_dict(fmif_convert.state_dict_from_flax(variables))
    return jax_model, variables, model


SEMLA_TINY = dict(d_model=32, vocab_size=6, n_atom_feats=6, d_edge=8, n_edge_types=5,
                  self_cond=True, size_emb=8, max_atoms=12, n_charge_types=7,
                  rep_alignment=True, d_message=16, n_coord_sets=4, n_layers=3,
                  n_attn_heads=4, d_message_hidden=16, d_rep=16, cond_type="none",
                  align_depth=(1,))


def semla_inputs(kw, batch=3, n=10, seed=1, pad=True):
    """Numpy keyword inputs of a SemlaGenerator of config `kw`: ragged
    masks (the last rows padded where `pad`), zero-CoM coordinates, one-hot
    types and symmetric one-hot bonds, soft self-conditioning inputs (where
    kw['self_cond']), a rep and times (where kw['d_rep'])."""
    rng = np.random.default_rng(seed)
    sizes = (rng.integers(n // 2, n + 1, size=batch) if pad
             else np.full(batch, n))
    if pad:
        sizes[0] = n
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)
    coords = rng.standard_normal((batch, n, 3)).astype(np.float32) * mask[..., None]
    coords -= coords.sum(1, keepdims=True) / mask.sum(1)[:, None, None]
    coords *= mask[..., None]

    def onehot(shape, k):
        return np.eye(k, dtype=np.float32)[rng.integers(0, k, size=shape)]

    def soft(shape, k):
        x = np.exp(rng.standard_normal(shape + (k,)))
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)

    pair = (mask[:, :, None] * mask[:, None, :])[..., None]
    out = {"coords": coords,
           "inv_feats": onehot((batch, n), kw["vocab_size"]) * mask[..., None],
           "atom_mask": mask}
    if kw.get("d_edge") is not None:
        idx = np.triu(rng.integers(0, kw["n_edge_types"], size=(batch, n, n)), 1)
        out["edge_feats"] = np.eye(kw["n_edge_types"], dtype=np.float32)[
            idx + idx.transpose(0, 2, 1)] * pair
    if kw.get("self_cond"):
        out["cond_coords"] = (rng.standard_normal((batch, n, 3)).astype(np.float32)
                              * mask[..., None])
        out["cond_atomics"] = soft((batch, n), kw["vocab_size"]) * mask[..., None]
        if kw.get("d_edge") is not None:
            out["cond_bonds"] = soft((batch, n, n), kw["n_edge_types"]) * pair
    if kw.get("d_rep") is not None:
        out["rep"] = rng.standard_normal((batch, kw["d_rep"])).astype(np.float32)
        out["times"] = rng.uniform(0, 1, batch).astype(np.float32)
    return out


def semla_random_params(jax_model, inputs, std=0.1, seed=0):
    """A numpy param tree of `jax_model`, every leaf ~ N(0, std), every
    LayerNorm scale, coordinate-set weight and size-table entry ~ 1 +
    N(0, std) (no leaf at its zero or unit init)."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in inputs.items()}))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = (rng.standard_normal(s.shape) * std).astype(np.float32)
        key = jax.tree_util.keystr(path)
        return x + 1.0 if key.endswith("['scale']") or "set_weights" in key else x

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def semla_pair(inputs=None, std=0.1, seed=0, **overrides):
    """(jax SemlaGenerator, its numpy params, port SemlaGenerator with the
    same weights, the numpy inputs)."""
    from reed_tpu.models.semla import SemlaGenerator as JaxSemla
    from reed_tpu_torch.encoders.semla_convert import state_dict_from_flax
    from reed_tpu_torch.models.semla import SemlaGenerator

    kw = dict(SEMLA_TINY, **overrides)
    inputs = semla_inputs(kw) if inputs is None else inputs
    jax_model = JaxSemla(**kw)
    params = semla_random_params(jax_model, inputs, std=std, seed=seed)
    model = SemlaGenerator(**kw).eval()
    model.load_state_dict(state_dict_from_flax(params))
    return jax_model, params, model, inputs


EDM_TINY = dict(in_node_nf=6, hidden_nf=32, n_layers=2, inv_sublayers=2, attention=True,
                tanh=True, coords_range=15.0, normalization_factor=1.0, aggregation="sum",
                rep_nf=16, rep_dropout_prob=0.1)


def edm_inputs(batch=3, n=9, nf=6, rep_nf=16, context_nf=0, seed=1):
    """Numpy inputs of a tiny EGNNDynamics: t [B], xh [B,N,3+nf] (zero-CoM
    coordinates, features), node_mask [B,N,1] with padded rows after the
    first, edge_mask [B,N,N,1], a rep and a per-node context where asked."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(n // 2, n + 1, size=batch)
    sizes[0] = n
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((batch, n, 3)).astype(np.float32) * mask
    x = (x - x.sum(1, keepdims=True) / mask.sum(1, keepdims=True)) * mask
    h = rng.standard_normal((batch, n, nf)).astype(np.float32) * mask
    edge = mask[:, :, None, :] * mask[:, None, :, :] * (1 - np.eye(n, dtype=np.float32)
                                                        [None, :, :, None])
    out = {"t": rng.uniform(0, 1, batch).astype(np.float32),
           "xh": np.concatenate([x, h], -1), "node_mask": mask, "edge_mask": edge}
    if rep_nf:
        out["rep"] = rng.standard_normal((batch, rep_nf)).astype(np.float32)
    if context_nf:
        out["context"] = rng.standard_normal((batch, n, context_nf)).astype(np.float32) * mask
    return out


def edm_pair(std=0.1, seed=0, **overrides):
    """(jax EGNNDynamics, its params, port EGNNDynamics): the port's every
    parameter ~ N(0, std), LayerNorm scales 1 + N(0, std), carried to
    reed_tpu by reed_tpu's own torch converter (convert_torch_egnn_dynamics)."""
    from reed_tpu.encoders.edm_convert import convert_torch_egnn_dynamics
    from reed_tpu.models.egnn import EGNNDynamics as JaxDynamics
    from reed_tpu_torch.models.egnn import EGNNDynamics

    kw = dict(EDM_TINY, **overrides)
    model = EGNNDynamics(**kw).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * std
                    + (1.0 if name.endswith(("norm2.weight", "norm3.weight")) else 0.0))
    params = convert_torch_egnn_dynamics(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return JaxDynamics(**kw), params, model
