"""RDM denoiser: a residual MLP over flat representation vectors,
conditioned on the timestep and the atom count. Counterpart of
reed_tpu/models/rdm_mlp.py (reference: molecule/models/rdm/modules/
diffusionmodules/latentmlp.py:10-160 SimpleMLP and ResBlock, and the
ClassEmbedder atom-count conditioner of qm9_rdm_unconditional.yaml).

Parameters carry the reference torch SimpleMLP's names (`time_embed.0/2`,
`input_proj`, `res_blocks.{i}.in_layers.0/2`, `emb_layers.1`,
`context_layers.1`, `out_layers.0/3`, `out.0/2`) and the LatentDiffusion's
class embedder as `cond_stage_model.embedding`, so reed_tpu's
`convert_torch_rdm` reads a port state_dict as it reads a reference one.
The class table has num_classes + 1 rows, as reed_tpu's. LayerNorm eps is
1e-5 in the blocks and flax's default 1e-6 in the final `out.0`.

Tensor parallelism (SimpleMLP's `parallel`, a parallel.mesh.DataParallel
with tensor T above 1; parallel/mesh.RDM_TP_RULES): a rank holds mid / T
of each residual block's columns: its columns of in_fc, emb_fc and
context_fc (with their biases), of out_norm's scale and bias, and the
matching input rows of out_fc, whose f32 partials the tensor group sums
once before the bias. out_norm normalises the rank's columns with the
statistics of the whole width (nn/layers.split_layer_norm, summed by
collectives.sum_over_tensor, whose backward sums the statistics'
gradients too, since every rank normalises other columns). The block's
input enters in_fc through copy_to_tensor, and so do the time and class
embeddings, once where they are made. A dropout mask is drawn at the whole
mid width and a rank keeps its columns, so that every tensor size draws
the same mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import (row_parallel, split_layer_norm, split_width,
                                      tensor_size, timestep_embedding)
from reed_tpu_torch.parallel import draws
from reed_tpu_torch.parallel.collectives import copy_to_tensor, sum_over_tensor


def _dropout(x, p: float, train: bool, generator: Optional[torch.Generator],
             parallel=None):
    """flax's Dropout: keep each element with 1 - p and scale it by 1 / (1 -
    p); under the tensor axis of `parallel` x holds a rank's columns, and
    the mask is drawn at the whole width, the rank's columns kept."""
    if not train or p == 0.0:
        return x
    w, tensor = x.shape[-1], tensor_size(parallel)
    keep = draws.rand(x.shape[:-1] + (w * tensor,), generator=generator,
                      device=x.device) >= p
    if tensor > 1:
        keep = keep[..., parallel.tensor_index * w:(parallel.tensor_index + 1) * w]
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class ResBlock(nn.Module):
    """x + out_layers(in_layers(x) + emb_layers(emb) + context_layers(context)).
    Under the tensor axis of `parallel` it holds its rank's mid columns (the
    module docstring); emb and context then come through copy_to_tensor."""

    def __init__(self, channels: int, mid_channels: int, emb_channels: int,
                 context_channels: Optional[int], dropout: float = 0.0, parallel=None):
        super().__init__()
        self.dropout = dropout
        self.parallel = parallel
        self.mid_channels = mid_channels
        mid = split_width(mid_channels, tensor_size(parallel), "the RDM block's mid width")
        self.in_layers = nn.Sequential(nn.LayerNorm(channels, eps=1e-5), nn.SiLU(),
                                       nn.Linear(channels, mid))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, mid))
        if context_channels is not None:
            self.context_layers = nn.Sequential(nn.SiLU(), nn.Linear(context_channels, mid))
        self.out_layers = nn.Sequential(nn.LayerNorm(mid, eps=1e-5), nn.SiLU(),
                                        nn.Dropout(dropout), nn.Linear(mid, channels))

    def forward(self, x, emb, context=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        parallel = self.parallel
        if tensor_size(parallel) == 1:
            h = self.in_layers(x) + self.emb_layers(emb)
        else:
            h = self.in_layers[2](copy_to_tensor(F.silu(self.in_layers[0](x)), parallel))
            h = h + self.emb_layers(emb)
        if context is not None and hasattr(self, "context_layers"):
            h = h + self.context_layers(context)
        if tensor_size(parallel) == 1:
            h = _dropout(F.silu(self.out_layers[0](h)), self.dropout, train, generator)
            return x + self.out_layers[3](h)
        norm = self.out_layers[0]
        h = F.silu(split_layer_norm(h, norm.weight, norm.bias, norm.eps, self.mid_channels,
                                    lambda t: sum_over_tensor(t, parallel)))
        h = _dropout(h, self.dropout, train, generator, parallel)
        return x + row_parallel(h, self.out_layers[3], parallel)


class ClassEmbedder(nn.Module):
    """The LatentDiffusion's atom-count embedder (rdm/modules/encoders/
    modules.py:12-20)."""

    def __init__(self, num_rows: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_rows, dim)


class SimpleMLP(nn.Module):
    """x0- (or eps-) prediction network of the representation DDPM:
    forward(x [B, C], t [B] integer timesteps, n_nodes [B] atom counts or
    None) -> [B, out_channels] f32. `parallel` splits the residual blocks
    over its tensor axis (the module docstring): the parameters are then a
    tensor rank's shards, whose names stay the whole model's
    (parallel/mesh.shard_state_dict)."""

    def __init__(self, in_channels: int = 256, time_embed_dim: int = 256,
                 model_channels: int = 1536, bottleneck_channels: int = 1536,
                 out_channels: int = 256, num_res_blocks: int = 18, dropout: float = 0.0,
                 use_context: bool = True, num_classes: int = 256,
                 context_channels: int = 256, parallel=None):
        super().__init__()
        self.model_channels = model_channels
        self.parallel = parallel
        self.time_embed = nn.Sequential(nn.Linear(model_channels, time_embed_dim), nn.SiLU(),
                                        nn.Linear(time_embed_dim, time_embed_dim))
        self.input_proj = nn.Linear(in_channels, model_channels)
        ctx = context_channels if use_context else None
        self.res_blocks = nn.ModuleList([
            ResBlock(model_channels, bottleneck_channels, time_embed_dim, ctx, dropout,
                     parallel)
            for _ in range(num_res_blocks)])
        self.out = nn.Sequential(nn.LayerNorm(model_channels, eps=1e-6), nn.SiLU(),
                                 nn.Linear(model_channels, out_channels))
        if use_context:
            self.cond_stage_model = ClassEmbedder(num_classes + 1, context_channels)

    @torch.no_grad()
    def initialize_weights(self, generator: Optional[torch.Generator] = None):
        """reed_tpu's (flax's default) initialisation: lecun-normal linears
        (a normal truncated at 2 sigma, scaled to variance 1 / fan_in) with
        zero biases, unit LayerNorms, the class table N(0, 1 / dim)
        truncated likewise, and both `out_fc` layers (`out_layers.3`,
        `out.2`) zero."""
        for name, m in self.named_modules():
            if isinstance(m, nn.Linear):
                if name.endswith("out_layers.3") or name == "out.2":
                    nn.init.zeros_(m.weight)
                else:
                    std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                std = m.weight.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
        return self

    def forward(self, x, t, n_nodes=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        emb = copy_to_tensor(self.time_embed(timestep_embedding(t, self.model_channels)),
                             self.parallel)
        context = None
        if n_nodes is not None and hasattr(self, "cond_stage_model"):
            context = copy_to_tensor(self.cond_stage_model.embedding(n_nodes.long()),
                                     self.parallel)
        h = self.input_proj(x.float())
        for block in self.res_blocks:
            h = block(h, emb, context, train, generator)
        return self.out(h).float()
