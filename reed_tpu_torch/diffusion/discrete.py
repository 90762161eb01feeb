"""Discrete (masking) flow matching: corruption and the Euler unmasking
sampler.

Counterpart of reed_tpu/diffusion/discrete.py (MaskingInterpolantConfig,
sample_t, corrupt_tokens, corrupt_batch, _step_probs, categorical_exp_race,
euler_unmask_sampler). t = 1 is clean data: training masks each token with
probability 1 - t, t and the uniforms drawn from a torch.Generator or passed
in, so that a test can hand over reed_tpu's. The sampler runs ts = linspace(min_t, 1, num_timesteps) in f32 (as
jnp.linspace computes it) and unmasks through the MDLM transition

    q_xs = softmax(logits / temp) * (t_2 - t_1),  q_xs[MASK] = 1 - t_2

with already-unmasked positions copied. Categorical draws are exponential
races, argmax(p / E) with E = -log(u); the uniforms u come from a
torch.Generator, or are passed in (`uniforms=`) so that a test can hand
over reed_tpu's draws. The loop runs on the host, one model call per step
(two with CFG).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from reed_tpu_torch.data.protein import MASK_TOKEN_INDEX, NUM_TOKENS
from reed_tpu_torch.diffusion.samplers import _linspace_f32

NEG_INF = -1e6


@dataclass(frozen=True)
class MaskingInterpolantConfig:
    num_tokens: int = NUM_TOKENS
    mask_index: int = MASK_TOKEN_INDEX
    min_t: float = 1e-2
    num_timesteps: int = 500
    temp: float = 0.1


def sample_t(num_batch: int, min_t: float, generator: Optional[torch.Generator] = None,
             device=None, uniforms: Optional[torch.Tensor] = None):
    """t ~ U[min_t, 1 - min_t], [num_batch] f32 (reference: fm_utils.py:40-42);
    `uniforms` [num_batch] replaces the generator's U[0, 1) draws."""
    if uniforms is None:
        uniforms = torch.rand((num_batch,), generator=generator, device=device)
    return uniforms.float() * (1 - 2 * min_t) + min_t


def corrupt_tokens(tokens, t, res_mask, mask_index: int = MASK_TOKEN_INDEX,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None):
    """Mask each valid token with probability 1 - t; invalid positions are
    forced to the mask token (reference: fm_utils.py:44-61). tokens [B,L],
    t [B] or [B,1], `uniforms` [B,L] replaces the generator's draws. Returns
    int32 [B,L]."""
    if t.dim() == 1:
        t = t[:, None]
    if uniforms is None:
        uniforms = torch.rand(tokens.shape, generator=generator, device=tokens.device)
    corrupted = torch.where(uniforms < (1.0 - t), mask_index, tokens)
    corrupted = torch.where(res_mask.bool(), corrupted, mask_index)
    return corrupted.to(torch.int32)


def corrupt_batch(batch, cfg: MaskingInterpolantConfig,
                  generator: Optional[torch.Generator] = None, t=None,
                  uniforms: Optional[torch.Tensor] = None):
    """The batch dict with S_t, t [B,1] and is_masked added (reference:
    fm_utils.py:63-87). t defaults to a draw of sample_t; `uniforms` go to
    corrupt_tokens."""
    s = batch["S"]
    b = s.shape[0]
    if t is None:
        t = sample_t(b, cfg.min_t, generator, device=s.device)[:, None]
    else:
        t = torch.as_tensor(t, dtype=torch.float32, device=s.device).reshape(-1, 1).expand(b, 1)
    res_mask = batch["mask"] * batch["chain_M"]
    s_t = corrupt_tokens(s, t, res_mask, cfg.mask_index, generator, uniforms)
    is_masked = (s_t == cfg.mask_index).to(res_mask.dtype) * res_mask
    return dict(batch, S_t=s_t, t=t, is_masked=is_masked)


def categorical_exp_race(probs, generator: Optional[torch.Generator] = None,
                         uniforms: Optional[torch.Tensor] = None):
    """idx ~ Categorical(probs) over the last axis via argmax(p / E), E =
    1e-10 - log(u + 1e-10), u ~ U[0, 1) drawn from `generator` unless
    `uniforms` (the shape of probs) is given. Unnormalised probs are fine."""
    if uniforms is None:
        uniforms = torch.rand(probs.shape, generator=generator, device=probs.device)
    e = 1e-10 - torch.log(uniforms.to(probs.device, torch.float32) + 1e-10)
    return torch.argmax(probs / e, dim=-1)


def _step_probs(logits, tokens_t, t_1, t_2, temp, mask_index, num_tokens):
    """The MDLM transition probabilities q_xs of one Euler step."""
    is_mask = torch.arange(num_tokens, device=logits.device) == mask_index
    logits = logits.masked_fill(is_mask, NEG_INF) / temp
    logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    unmasked = (tokens_t != mask_index)[..., None]
    # a comparison, not F.one_hot, which syncs the host to check the indices
    onehot = tokens_t[..., None] == torch.arange(num_tokens, device=tokens_t.device)
    # force a copy of the already-unmasked positions
    logits = torch.where(unmasked, torch.where(onehot, 0.0, NEG_INF), logits)
    q_xs = torch.exp(logits) * float(t_2 - t_1)
    return q_xs.masked_fill(is_mask, float(1 - t_2))


def euler_unmask_sampler(model_logits_fn: Callable, batch_shape,
                         cfg: MaskingInterpolantConfig,
                         generator: Optional[torch.Generator] = None,
                         cls: Optional[int] = None, w: Optional[float] = None,
                         num_cls: int = 2, device=None,
                         uniforms: Optional[torch.Tensor] = None):
    """Euler unmasking sampler.

    model_logits_fn(tokens [B,L] int32, cls [B] int32 or None) -> logits
    [B,L,V]. With `cls`, CFG over the class label: (1 + w) * cond - w *
    uncond, the unconditional class being num_cls. `uniforms`
    ([num_timesteps - 1, B, L, V]) replaces the generator's draws. Returns
    (pred_tokens, final_tokens): the argmax prediction of the last step and
    the sampled end of the trajectory, int32 [B,L]."""
    b, l = batch_shape
    steps = cfg.num_timesteps - 1
    if uniforms is not None and tuple(uniforms.shape) != (steps, b, l, cfg.num_tokens):
        raise ValueError(f"uniforms must have shape {(steps, b, l, cfg.num_tokens)}, "
                         f"got {tuple(uniforms.shape)}")
    ts = _linspace_f32(cfg.min_t, 1.0, cfg.num_timesteps)
    tokens = torch.full((b, l), cfg.mask_index, dtype=torch.int32, device=device)
    pred = tokens

    def logits_at(tokens):
        if cls is None:
            return model_logits_fn(tokens, None).float()
        uncond = torch.full((b,), num_cls, dtype=torch.int32, device=device)
        cond = torch.full((b,), cls, dtype=torch.int32, device=device)
        lo_u = model_logits_fn(tokens, uncond).float()
        lo_c = model_logits_fn(tokens, cond).float()
        return (1.0 + w) * lo_c - w * lo_u

    for i in range(steps):
        logits = logits_at(tokens)
        is_mask = torch.arange(cfg.num_tokens, device=logits.device) == cfg.mask_index
        pred = torch.argmax(logits.masked_fill(is_mask, -1e9), dim=-1).to(torch.int32)
        q_xs = _step_probs(logits, tokens, ts[i], ts[i + 1], cfg.temp,
                           cfg.mask_index, cfg.num_tokens)
        new = categorical_exp_race(q_xs, generator,
                                   None if uniforms is None else uniforms[i])
        tokens = torch.where(tokens != cfg.mask_index, tokens, new.to(torch.int32))
    return pred, tokens
