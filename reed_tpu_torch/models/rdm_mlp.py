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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch.nn.layers import timestep_embedding
from reed_tpu_torch.parallel import draws


def _dropout(x, p: float, train: bool, generator: Optional[torch.Generator]):
    """flax's Dropout: keep each element with 1 - p and scale it by 1 / (1 - p)."""
    if not train or p == 0.0:
        return x
    keep = draws.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class ResBlock(nn.Module):
    """x + out_layers(in_layers(x) + emb_layers(emb) + context_layers(context))."""

    def __init__(self, channels: int, mid_channels: int, emb_channels: int,
                 context_channels: Optional[int], dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.in_layers = nn.Sequential(nn.LayerNorm(channels, eps=1e-5), nn.SiLU(),
                                       nn.Linear(channels, mid_channels))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, mid_channels))
        if context_channels is not None:
            self.context_layers = nn.Sequential(nn.SiLU(),
                                                nn.Linear(context_channels, mid_channels))
        self.out_layers = nn.Sequential(nn.LayerNorm(mid_channels, eps=1e-5), nn.SiLU(),
                                        nn.Dropout(dropout), nn.Linear(mid_channels, channels))

    def forward(self, x, emb, context=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)
        if context is not None and hasattr(self, "context_layers"):
            h = h + self.context_layers(context)
        h = F.silu(self.out_layers[0](h))
        h = _dropout(h, self.dropout, train, generator)
        return x + self.out_layers[3](h)


class ClassEmbedder(nn.Module):
    """The LatentDiffusion's atom-count embedder (rdm/modules/encoders/
    modules.py:12-20)."""

    def __init__(self, num_rows: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num_rows, dim)


class SimpleMLP(nn.Module):
    """x0- (or eps-) prediction network of the representation DDPM:
    forward(x [B, C], t [B] integer timesteps, n_nodes [B] atom counts or
    None) -> [B, out_channels] f32."""

    def __init__(self, in_channels: int = 256, time_embed_dim: int = 256,
                 model_channels: int = 1536, bottleneck_channels: int = 1536,
                 out_channels: int = 256, num_res_blocks: int = 18, dropout: float = 0.0,
                 use_context: bool = True, num_classes: int = 256,
                 context_channels: int = 256):
        super().__init__()
        self.model_channels = model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, time_embed_dim), nn.SiLU(),
                                        nn.Linear(time_embed_dim, time_embed_dim))
        self.input_proj = nn.Linear(in_channels, model_channels)
        ctx = context_channels if use_context else None
        self.res_blocks = nn.ModuleList([
            ResBlock(model_channels, bottleneck_channels, time_embed_dim, ctx, dropout)
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
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        context = None
        if n_nodes is not None and hasattr(self, "cond_stage_model"):
            context = self.cond_stage_model.embedding(n_nodes.long())
        h = self.input_proj(x.float())
        for block in self.res_blocks:
            h = block(h, emb, context, train, generator)
        return self.out(h).float()
