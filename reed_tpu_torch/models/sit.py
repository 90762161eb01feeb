"""SiT: Scalable Interpolant Transformer with REED projectors (torch.nn).

Counterpart of reed_tpu/models/sit.py with the reference's parameter names
(x_embedder.proj, t_embedder.mlp.{0,2}, y_embedder.embedding_table,
blocks.{i}.{adaLN_modulation.1,attn.{qkv,proj},mlp.{fc1,fc2}},
projectors.{j}.{0,2,4}, final_layer.{adaLN_modulation.1,linear}), so a
reference state_dict loads with `load_state_dict`. Inputs and outputs are
NHWC like reed_tpu's. The model computes in `compute_dtype`, as flax's
modules with `dtype=` do: its parameters (f32 master weights in training)
are cast where they are used, the residual stream stays in the compute
dtype, LayerNorm statistics are f32 and the velocity is returned in f32.
`compute_dtype=None` computes in the parameters' dtype, so a model built in
f32 and `.to(torch.bfloat16)` runs in bf16 as before.

`remat` is reed_tpu's activation checkpointing of the blocks (its nn.remat
of SiTBlock): False keeps every activation; True saves only each block's
input and recomputes the block in the backward
(torch.utils.checkpoint, non-reentrant); a jax.checkpoint_policies name
saves the products that policy keeps and recomputes the rest (a selective
checkpoint over aten ops): 'dots' (reed_tpu's name for
dots_with_no_batch_dims_saveable) saves the outputs of mm and addmm, the
linear layers' products; 'dots_saveable' adds bmm and baddbmm. The
attention kernel K1 launches outside the dispatcher, so no policy keeps
its output: under remat it runs again in the backward. The blocks draw no
random numbers (the label drop happens before them), so the recompute
sees what the forward saw.

`parallel` (a parallel.mesh.DataParallel) splits the model over its seq
and tensor axes. Under tensor T each block holds a tensor rank's shards
(nn/layers.Attention and Mlp: H/T heads, 1/T of the MLP; the parameter
names stay the reference's, the shapes are the shards',
parallel/mesh.shard_state_dict); the embedders, adaLN linears,
final layer and projectors are whole on every rank. Under seq S a rank
patchifies the whole latent and keeps its slice of the tokens (and of the
position embedding), its blocks attend to every rank's keys, the velocity
and the per-token projector outputs are gathered over the seq group and
the pooled ('t') projector takes the mean of every rank's tokens, so every
rank returns the whole outputs. A checkpointed block runs its collectives
again in its recompute, in one order on every rank: under the fsdp axis
(parameters sharded at rest) that includes the gather of its weights
(`fsdp_units`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from reed_tpu_torch.nn.layers import (
    Attention,
    LabelEmbedder,
    Mlp,
    ProjectorMLP,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
    linear,
    modulate,
    patchify,
    unpatchify,
)
from reed_tpu_torch.parallel.collectives import gather_seq, sum_seq


# jax.checkpoint_policies names -> the aten products whose outputs a block
# saves under remat (True: nothing; False: everything)
_NO_BATCH_DOTS = ("mm", "addmm")
_DOTS = _NO_BATCH_DOTS + ("bmm", "baddbmm")
REMAT_POLICIES = {
    "dots": _NO_BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "nothing_saveable": (),
    "everything_saveable": None,
}


def remat_saves(remat: Any) -> Optional[tuple]:
    """The aten products a block saves under `remat` (reed_tpu's setting):
    None for no checkpointing (False, 'everything_saveable'), () for the
    whole block recomputed (True, 'nothing_saveable'), else the names a
    selective policy keeps. Raises ValueError on another policy name."""
    if isinstance(remat, str):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat policy {remat!r} is not supported: use False, True "
                             f"or one of {sorted(REMAT_POLICIES)}")
        return REMAT_POLICIES[remat]
    return () if remat else None


def _save_products(names, ctx, op, *args, **kwargs):
    """The selective checkpoint's policy: keep the outputs of `names`."""
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket.__name__ in names
            else CheckpointPolicy.PREFER_RECOMPUTE)


def layer_norm(x):
    """LayerNorm without affine parameters, eps 1e-6, statistics in f32
    (as flax computes them for a bf16 input)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class PatchEmbed(nn.Module):
    """Patch embedding. `proj` keeps the reference conv's weight shape
    [D, C, p, p] but is applied as row-major NHWC patchify + a linear map:
    the same arithmetic without cuDNN, whose f32 convolutions run in TF32."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size,
                              stride=patch_size)

    def forward(self, x, tokens: Optional[slice] = None):
        """The embedding of the patches of x ([B, H, W, C]), of the slice
        `tokens` of them where given."""
        w = self.proj.weight.to(x.dtype)
        w = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)  # [D, p*p*C]
        patches = patchify(x, self.patch_size)
        if tokens is not None:
            patches = patches[:, tokens]
        return F.linear(patches, w, self.proj.bias.to(x.dtype))


class SiTBlock(nn.Module):
    """adaLN-Zero transformer block."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 exact_gelu: bool = False, tensor: int = 1):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, qkv_bias=True, tensor=tensor)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio),
                       exact_gelu=exact_gelu, tensor=tensor)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x, c, attn_impl: str = "auto", parallel=None):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = linear(
             F.silu(c), self.adaLN_modulation[1]).chunk(6, dim=-1)
        h = modulate(layer_norm(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None, :] * self.attn(h, attn_impl=attn_impl, parallel=parallel)
        h = modulate(layer_norm(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * self.mlp(h, parallel=parallel)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))
        self.linear = nn.Linear(hidden_size, patch_size ** 2 * out_channels)

    def forward(self, x, c):
        shift, scale = linear(F.silu(c), self.adaLN_modulation[1]).chunk(2, dim=-1)
        return linear(modulate(layer_norm(x), shift, scale), self.linear)


class SiT(nn.Module):
    def __init__(self, input_size: int = 32, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 class_dropout_prob: float = 0.1, num_classes: int = 1000,
                 encoder_depth: int = 8, encoder_depth_text: Optional[int] = None,
                 z_dims: Sequence[int] = (768,), z_types: Sequence[str] = ("i",),
                 projector_dim: int = 2048, attn_impl: str = "auto",
                 exact_gelu: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, remat: Any = False,
                 parallel=None):
        super().__init__()
        # what a block saves under activation checkpointing (remat_saves)
        self.remat_saves = remat_saves(remat)
        # the mesh (a parallel.mesh.DataParallel) whose seq and tensor axes
        # split this model, or None
        self.parallel = parallel
        tensor = 1 if parallel is None else parallel.tensor
        seq = 1 if parallel is None else parallel.seq
        num_tokens = (input_size // patch_size) ** 2
        if num_tokens % seq:
            raise ValueError(f"seq={seq} does not divide SiT's {num_tokens} tokens")
        # this rank's tokens under seq
        n = num_tokens // seq
        self.tokens = (None if seq == 1 else
                       slice(parallel.seq_index * n, (parallel.seq_index + 1) * n))
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.encoder_depth = encoder_depth
        self.encoder_depth_text = encoder_depth_text
        self.z_types = tuple(z_types)
        # 'auto' (kernel on CUDA) or 'reference' (plain attention)
        self.attn_impl = attn_impl
        # None: the parameters' dtype
        self.compute_dtype = compute_dtype

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size,
                                        class_dropout_prob)
        pos = get_2d_sincos_pos_embed(hidden_size, input_size // patch_size)
        # fixed, recomputed at construction, so not part of the state_dict
        self.register_buffer(
            "pos_embed",
            torch.as_tensor(pos, device=self.x_embedder.proj.weight.device)[None],
            persistent=False)
        self.blocks = nn.ModuleList(
            SiTBlock(hidden_size, num_heads, mlp_ratio, exact_gelu=exact_gelu,
                     tensor=tensor)
            for _ in range(depth))
        self.projectors = nn.ModuleList(
            ProjectorMLP(hidden_size, projector_dim, z) for z in z_dims)
        self.final_layer = FinalLayer(hidden_size, patch_size, in_channels)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's initialisation: xavier-uniform linears (the patch
        embedding over its [D, p*p*C] view), N(0, 0.02) timestep MLP and
        label table, zero biases, zero adaLN and final layers (so the
        velocity is 0 at init)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1), generator=generator)
        nn.init.zeros_(self.x_embedder.proj.bias)
        for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
        nn.init.normal_(self.y_embedder.embedding_table.weight, std=0.02,
                        generator=generator)
        for blk in self.blocks:
            nn.init.zeros_(blk.adaLN_modulation[1].weight)
            nn.init.zeros_(blk.adaLN_modulation[1].bias)
        for lin in (self.final_layer.adaLN_modulation[1], self.final_layer.linear):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x, t, y, train: bool = False,
                return_zs: Optional[bool] = None, drop=None,
                generator: Optional[torch.Generator] = None):
        """x: [B, H, W, C] NHWC latents; t: [B] in [0, 1] (0 = clean); y: [B]
        int labels (num_classes = null/CFG class). Returns (velocity f32
        NHWC, zs or None); zs are the projector outputs when return_zs,
        which defaults to `train`. In training the labels take CFG dropout:
        `drop` (bool [B]) marks the ones replaced by the null class, else
        they are drawn from `generator` (LabelEmbedder)."""
        if return_zs is None:
            return_zs = train
        dtype = self.compute_dtype or self.x_embedder.proj.weight.dtype
        x = self.x_embedder(x.to(dtype), self.tokens)
        pos = self.pos_embed if self.tokens is None else self.pos_embed[:, self.tokens]
        x = x + pos.to(dtype)
        c = self.t_embedder(t, dtype) + self.y_embedder(
            y, dtype, train=train, drop=drop, generator=generator)

        zs_image, zs_text = None, None
        depth_text = self.encoder_depth_text
        split_text = depth_text is not None and depth_text != self.encoder_depth
        for i, block in enumerate(self.blocks):
            x = self._block(block, x, c)
            if return_zs and (i + 1) == self.encoder_depth:
                if not split_text:
                    zs_image = [self._project(j, x, dtype) if zt == "i"
                                else self._project_pooled(j, x, dtype)
                                for j, zt in enumerate(self.z_types)]
                else:
                    zs_image = [self._project(j, x, dtype)
                                for j, zt in enumerate(self.z_types) if zt == "i"]
            if return_zs and split_text and (i + 1) == depth_text:
                zs_text = [self._project_pooled(j, x, dtype)
                           for j, zt in enumerate(self.z_types) if zt == "t"]

        zs = None
        if return_zs:
            zs = (list(zs_image or []) + list(zs_text or []) if split_text
                  else zs_image)
        x = gather_seq(self.final_layer(x, c).float(), 1, self.parallel)
        return unpatchify(x, self.patch_size, self.in_channels), zs

    def _block(self, block, x, c):
        """`block` on (x, c), checkpointed as `remat` asks where autograd
        records."""
        saves = self.remat_saves
        if saves is None or not torch.is_grad_enabled():
            return block(x, c, attn_impl=self.attn_impl, parallel=self.parallel)
        kwargs = {}
        if saves:
            kwargs["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                functools.partial(_save_products, frozenset(saves)))
        return checkpoint(block, x, c, self.attn_impl, self.parallel, use_reentrant=False,
                          **kwargs)

    def fsdp_units(self):
        """The modules whose parameters the fsdp axis gathers together
        (parallel/mesh.ShardPlan.units), each with the dtype it gathers them
        in: every block, in the compute dtype (each of a block's weights is
        cast to it once, where it is used). A block's gather runs in its
        forward, so under remat its recompute gathers again."""
        return [(block, self.compute_dtype) for block in self.blocks]

    def _project(self, idx: int, h, dtype):
        """Projector `idx` on h taken to f32 and computed in `dtype`, as
        reed_tpu's _project feeds h.astype(f32) to a Dense of that dtype;
        per token, so under seq on this rank's tokens, then gathered."""
        return gather_seq(self.projectors[idx](h.float().to(dtype)), 1, self.parallel)

    def _project_pooled(self, idx: int, h, dtype):
        """Projector `idx` on the token mean of h (in `dtype`, as reed_tpu's
        h.mean(axis=1)); under seq the mean of every rank's tokens, an f32
        sum over the seq group."""
        if self.tokens is None:
            return self._project(idx, h.mean(dim=1), dtype)
        total = sum_seq(h.float().sum(dim=1), self.parallel)
        n = self.pos_embed.shape[1]
        return self.projectors[idx]((total / n).to(dtype))


# Size registry mirroring the reference's 12 configs.
_SIZES = {
    "SiT-XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "SiT-L": dict(depth=24, hidden_size=1024, num_heads=16),
    "SiT-B": dict(depth=12, hidden_size=768, num_heads=12),
    "SiT-S": dict(depth=12, hidden_size=384, num_heads=6),
}


def create_sit(name: str, device=None, **kwargs) -> SiT:
    """name: e.g. 'SiT-XL/2' (size x patch size); the module is built on
    `device` (default: the current default device), in f32."""
    size, patch = name.rsplit("/", 1)
    cfg = dict(_SIZES[size])
    cfg["patch_size"] = int(patch)
    cfg.update(kwargs)
    with torch.device(device) if device is not None else contextlib.nullcontext():
        return SiT(**cfg)


SiT_models = {
    f"{size}/{p}": (lambda size=size, p=p: dict(_SIZES[size], patch_size=p))
    for size in _SIZES for p in (2, 4, 8)
}
