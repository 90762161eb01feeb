"""Reference RDM checkpoints (GeoRCG's LatentDiffusion over encoder
representations) into the port's SimpleMLP. Counterpart of
reed_tpu/encoders/rdm_convert.py.

The reference LatentDiffusion keeps its denoiser, the SimpleMLP
(molecule/models/rdm/modules/diffusionmodules/latentmlp.py:10-160), under
`model.diffusion_model.*` (and an EMA copy under `model_ema.*`, not read)
and its atom-count conditioner, a ClassEmbedder
(rdm/modules/encoders/modules.py:12-20), under
`cond_stage_model.embedding.weight`. The port's SimpleMLP has the same
names without the prefix and holds the class table itself, one row longer
than the reference's (the extra row zero-padded here, as reed_tpu pads
it), so `model.load_state_dict(strip_state_dict(...))` loads one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

EMBEDDING = "cond_stage_model.embedding.weight"
PREFIX = "model.diffusion_model."


def strip_state_dict(sd: Dict, num_rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A LatentDiffusion (or bare SimpleMLP) state dict, with or without a
    `module.` prefix, as the port's SimpleMLP names it; the class table cut
    or zero-padded to num_rows where given."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
          for k, v in sd.items()}
    prefix = PREFIX if any(k.startswith(PREFIX) for k in sd) else ""
    out = {k[len(prefix):]: v.float() for k, v in sd.items() if k.startswith(prefix)
           and k != EMBEDDING and not k.startswith("model_ema.")
           and not k.startswith("cond_stage_model.")}
    if EMBEDDING in sd:
        table = sd[EMBEDDING].float()
        if num_rows is not None and num_rows != table.shape[0]:
            padded = torch.zeros((num_rows, table.shape[1]), dtype=table.dtype)
            rows = min(num_rows, table.shape[0])
            padded[:rows] = table[:rows]
            table = padded
        out[EMBEDDING] = table
    return out


def read_checkpoint(path: str) -> Dict:
    """The state dict of a reference RDM .ckpt/.pt: its `state_dict` key, or
    the file itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt


def widths(sd: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The SimpleMLP widths a (stripped) state dict holds, as reed_tpu's
    eval-molecule infers them."""
    blocks = sum(1 for k in sd if k.startswith("res_blocks.") and k.endswith(
        ".in_layers.0.weight"))
    return {"in_channels": sd["input_proj.weight"].shape[1],
            "model_channels": sd["input_proj.weight"].shape[0],
            "bottleneck_channels": sd["res_blocks.0.in_layers.2.weight"].shape[0],
            "time_embed_dim": sd["time_embed.0.weight"].shape[0],
            "out_channels": sd["out.2.weight"].shape[0],
            "num_res_blocks": blocks,
            "use_context": EMBEDDING in sd,
            "context_channels": (sd[EMBEDDING].shape[1] if EMBEDDING in sd
                                 else sd["input_proj.weight"].shape[1])}
