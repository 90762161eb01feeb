"""Discrete (masking) flow matching: corruption, the Euler unmasking
sampler, its reward-guided variants (classifier gradient, SMC and twisted
SMC) and the differentiable Gumbel-softmax sampler.

Counterpart of reed_tpu/diffusion/discrete.py (MaskingInterpolantConfig,
sample_t, corrupt_tokens, corrupt_batch, _step_probs, categorical_exp_race,
euler_unmask_sampler, euler_unmask_sampler_controlled_cg, _resample,
euler_unmask_sampler_controlled_smc, gumbel_softmax_sampler). t = 1 is
clean data: training masks each token with probability 1 - t, t and the
uniforms drawn from a torch.Generator or passed in, so that a test can hand
over reed_tpu's. The samplers run ts = linspace(min_t, 1, num_timesteps) in
f32 (as jnp.linspace computes it) and unmask through the MDLM transition

    q_xs = softmax(logits / temp) * (t_2 - t_1),  q_xs[MASK] = 1 - t_2

with already-unmasked positions copied. Categorical draws are exponential
races, argmax(p / E) with E = -log(u); the uniforms u come from a
torch.Generator, or are passed in (`uniforms=`, one [B, L, V] slab a step)
so that a test can hand over reed_tpu's draws. The particle resampling of
SMC is jax.random.choice's inverse-CDF rule on one uniform a particle
(`resample_uniforms=`). The loops run on the host, one model call per step
(two with CFG; the guided samplers add the reward gradient's forward and
backward, and SMC the reward of the proposal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from reed_tpu_torch.data.protein import MASK_TOKEN_INDEX, NUM_TOKENS
from reed_tpu_torch.diffusion.samplers import _linspace_f32
from reed_tpu_torch.parallel import draws

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
        uniforms = draws.rand((num_batch,), generator=generator, device=device)
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
        uniforms = draws.rand(tokens.shape, generator=generator, device=tokens.device)
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
        uniforms = draws.rand(probs.shape, generator=generator, device=probs.device)
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
    the sampled end of the trajectory, int32 [B,L]. Inside
    draws.global_rows the batch is this rank's rows of the global batch:
    the uniforms are drawn, or given, at the global shape and its rows
    kept."""
    b, l = batch_shape
    steps = cfg.num_timesteps - 1
    uniforms = draws.keep(uniforms, axis=1)
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


def _onehot(tokens, num_tokens: int):
    """f32 one-hot of int tokens (a comparison: no host sync)."""
    return (tokens[..., None] == torch.arange(num_tokens, device=tokens.device)).float()


def _check_draws(name, draws, shape):
    if draws is not None and tuple(draws.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(draws.shape)}")


def _draw(given, i, shape, generator, device):
    """Step i's uniforms: this rank's rows of given[i] (global rows) where
    given, else drawn from `generator` for the global batch."""
    if given is not None:
        return draws.keep(given[i]).to(device)
    return draws.rand(shape, generator=generator, device=device)


def reward_gradient(model_logits_fn: Callable, reward_fn: Callable, x_onehot):
    """d mean(reward_fn(model_logits_fn(x, None))) / d x at a leaf copy of
    the (soft) one-hot x [B, L, V], the classifier gradient of CG and TDS;
    it runs with autograd whatever the caller's grad mode is. A reward that
    does not depend on x has the gradient 0, as jax.grad gives it."""
    x = x_onehot.detach().float().requires_grad_(True)
    with torch.enable_grad():
        reward = reward_fn(model_logits_fn(x, None)).mean()
        if not reward.requires_grad:
            return torch.zeros_like(x)
        (grad,) = torch.autograd.grad(reward, x, allow_unused=True)
    return torch.zeros_like(x) if grad is None else grad


def _guidance(grad, scale: float, mask_index: int):
    """scale * (dR/dx - dR/dx[MASK]): the log tilt of the proposal."""
    return scale * (grad - grad[..., mask_index:mask_index + 1])


def _mask_argmax(logits, cfg: MaskingInterpolantConfig):
    is_mask = torch.arange(cfg.num_tokens, device=logits.device) == cfg.mask_index
    return torch.argmax(logits.masked_fill(is_mask, -1e9), dim=-1).to(torch.int32)


@torch.no_grad()
def euler_unmask_sampler_controlled_cg(model_logits_fn: Callable, reward_fn: Callable,
                                       batch_shape, cfg: MaskingInterpolantConfig,
                                       guidance_scale: float = 1.0,
                                       generator: Optional[torch.Generator] = None,
                                       device=None, uniforms: Optional[torch.Tensor] = None):
    """Classifier-gradient reward guidance (reference: fm_utils.py:214-270).

    model_logits_fn(x, None) takes int32 tokens [B,L] or a one-hot [B,L,V];
    reward_fn(logits [B,L,V]) -> reward [B]. Each step multiplies q_xs by
    exp(scale * (dR/dx - dR/dx[MASK])), dR/dx the gradient of the mean
    reward of the model's logits at the one-hot of the current tokens.
    `uniforms` ([num_timesteps - 1, B, L, V]) replaces the generator's
    draws. Returns (pred_tokens, final_tokens), int32 [B,L]."""
    b, l = batch_shape
    v, steps = cfg.num_tokens, cfg.num_timesteps - 1
    _check_draws("uniforms", uniforms, (steps, b, l, v))
    ts = _linspace_f32(cfg.min_t, 1.0, cfg.num_timesteps)
    tokens = torch.full((b, l), cfg.mask_index, dtype=torch.int32, device=device)
    pred = tokens
    for i in range(steps):
        logits = model_logits_fn(tokens, None).float()
        pred = _mask_argmax(logits, cfg)
        q_xs = _step_probs(logits, tokens, ts[i], ts[i + 1], cfg.temp, cfg.mask_index, v)
        grad = reward_gradient(model_logits_fn, reward_fn, _onehot(tokens, v))
        q_xs = q_xs * torch.exp(_guidance(grad, guidance_scale, cfg.mask_index))
        new = categorical_exp_race(q_xs, uniforms=_draw(uniforms, i, q_xs.shape, generator,
                                                        q_xs.device))
        tokens = torch.where(tokens != cfg.mask_index, tokens, new.to(torch.int32))
    return pred, tokens


def _resample(weights, *arrays, generator: Optional[torch.Generator] = None,
              uniforms: Optional[torch.Tensor] = None):
    """Multinomial particle resampling across the batch axis (reference:
    fm_utils.py:334-338), by jax.random.choice(key, b, (b,), p=p)'s rule:
    c = cumsum(p), idx = searchsorted(c, c[-1] * (1 - u)) (side left) with
    u ~ U[0, 1) a particle, drawn from `generator` or passed in
    (`uniforms` [b]). Returns the arrays indexed by idx."""
    b = weights.shape[0]
    if uniforms is None:
        uniforms = torch.rand((b,), generator=generator, device=weights.device)
    p = weights / torch.sum(weights)
    c = torch.cumsum(p, dim=0)
    idx = torch.searchsorted(c, c[-1] * (1 - uniforms.to(c.device, c.dtype)))
    return tuple(a[idx] for a in arrays)


@torch.no_grad()
def euler_unmask_sampler_controlled_smc(model_logits_fn: Callable, reward_fn: Callable,
                                        batch_shape, cfg: MaskingInterpolantConfig,
                                        alpha: float = 1.0,
                                        guidance_scale: Optional[float] = None,
                                        generator: Optional[torch.Generator] = None,
                                        device=None,
                                        uniforms: Optional[torch.Tensor] = None,
                                        resample_uniforms: Optional[torch.Tensor] = None):
    """SMC / TDS reward-guided sampling (reference: fm_utils.py:272-424).

    With guidance_scale None this is plain SMC: propose one Euler step,
    then resample the particles (the batch) with weights exp((R(x_s) -
    R(x_t)) / alpha), R the reward of the argmax-improved completion (the
    model's argmax at the masked positions, one-hot, no gradient). With a
    guidance_scale the proposal is CG-tilted and the weights divide out the
    tilt of the drawn tokens (TDS). `uniforms` ([num_timesteps - 1, B, L,
    V]) and `resample_uniforms` ([num_timesteps - 1, B]) replace the
    generator's draws (each step draws its race, then its resampling).
    Returns (pred_tokens, final_tokens), int32 [B,L]."""
    b, l = batch_shape
    v, steps = cfg.num_tokens, cfg.num_timesteps - 1
    _check_draws("uniforms", uniforms, (steps, b, l, v))
    _check_draws("resample_uniforms", resample_uniforms, (steps, b))
    ts = _linspace_f32(cfg.min_t, 1.0, cfg.num_timesteps)
    tokens = torch.full((b, l), cfg.mask_index, dtype=torch.int32, device=device)
    pred = tokens

    def improved_reward(tokens, logits):
        x0 = torch.argmax(logits, dim=-1).to(torch.int32)
        return reward_fn(_onehot(torch.where(tokens != cfg.mask_index, tokens, x0), v))

    for i in range(steps):
        logits = model_logits_fn(tokens, None).float()
        pred = _mask_argmax(logits, cfg)
        q_xs = _step_probs(logits, tokens, ts[i], ts[i + 1], cfg.temp, cfg.mask_index, v)
        if guidance_scale is not None:
            grad = reward_gradient(model_logits_fn, reward_fn, _onehot(tokens, v))
            tilt_all = torch.exp(_guidance(grad, guidance_scale, cfg.mask_index))
            q_xs = q_xs * tilt_all
        new = categorical_exp_race(q_xs, uniforms=_draw(uniforms, i, q_xs.shape, generator,
                                                        q_xs.device))
        copy = tokens != cfg.mask_index
        tokens_next = torch.where(copy, tokens, new.to(torch.int32))
        # the current tokens' logits are this step's: the model is not run again
        log_w = (improved_reward(tokens_next, model_logits_fn(tokens_next, None).float())
                 - improved_reward(tokens, logits)) / alpha
        if guidance_scale is not None:
            tilt = torch.gather(tilt_all, -1, new[..., None])[..., 0]
            tilt = torch.where(copy, 1.0, tilt)
            log_w = log_w - torch.sum(torch.log(tilt), dim=-1)
        weights = torch.exp(log_w - torch.max(log_w))
        tokens, pred = _resample(weights, tokens_next, pred, uniforms=_draw(
            resample_uniforms, i, (b,), generator, weights.device))
    return pred, tokens


def gumbel_softmax_sampler(model_logits_fn: Callable, batch_shape,
                           cfg: MaskingInterpolantConfig, truncate_steps: int,
                           gumbel_softmax_temp: float = 1.0,
                           generator: Optional[torch.Generator] = None, device=None,
                           uniforms: Optional[torch.Tensor] = None):
    """Differentiable sampler (reference: fm_utils.py:145-212): hard
    categorical steps (no gradient) until the last `truncate_steps`, then
    Gumbel-softmax relaxed steps, and a straight-through output x + (hard -
    x).detach(), hard the one-hot argmax over the tokens but the mask.
    model_logits_fn(x [B,L,V] soft one-hot, None) -> logits; the argmax of
    x stands for the tokens in the transition. A step's relaxation takes the
    same uniforms as its hard draw (reed_tpu draws both from one key);
    `uniforms` ([num_timesteps - 1, B, L, V]) replaces the generator's.
    Returns the [B,L,V] output, differentiable in the model's parameters
    through the relaxed steps."""
    b, l = batch_shape
    v, steps = cfg.num_tokens, cfg.num_timesteps - 1
    _check_draws("uniforms", uniforms, (steps, b, l, v))
    ts = _linspace_f32(cfg.min_t, 1.0, cfg.num_timesteps)
    x = _onehot(torch.full((b, l), cfg.mask_index, dtype=torch.int32, device=device), v)
    for i in range(steps):
        logits = model_logits_fn(x, None).float()
        tokens_argmax = torch.argmax(x, dim=-1)
        q_xs = _step_probs(logits, tokens_argmax, ts[i], ts[i + 1], cfg.temp,
                           cfg.mask_index, v)
        u = _draw(uniforms, i, q_xs.shape, generator, q_xs.device).float()
        if i < cfg.num_timesteps - truncate_steps:
            new_hard = _onehot(categorical_exp_race(q_xs, uniforms=u), v)
            copy_hard = (tokens_argmax != cfg.mask_index)[..., None]
            x = torch.where(copy_hard, x, new_hard).detach()
        else:
            e = 1e-10 - torch.log(u + 1e-10)
            soft = torch.softmax((torch.log(q_xs + 1e-8) - torch.log(e))
                                 / gumbel_softmax_temp, dim=-1)
            copy_soft = 1.0 - x[..., cfg.mask_index:cfg.mask_index + 1]
            x = x * copy_soft + soft * (1.0 - copy_soft)
    hard = _onehot(torch.argmax(x[..., :-1], dim=-1), v)
    return x + (hard - x).detach()
