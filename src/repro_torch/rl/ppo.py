"""PPO objective (Clean PuffeRL): the clipped policy-gradient terms, the
clipped value loss and minibatch advantage normalization.

The counterpart of ``repro/rl/ppo.py`` on one device. Two loss entry
points:
  * ``ppo_terms`` — the clipped objective on precomputed log-probs;
  * ``chunked_token_loss`` — the LM-backbone path: the unembed, softmax and
    PPO terms per sequence chunk, each chunk under
    ``torch.utils.checkpoint``, so that the full (B, T, vocab) logits never
    exist and the backward recomputes a chunk's.
The data-parallel statistics of ``normalize_adv`` come with the
data-parallel slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as tr


class PPOStats(NamedTuple):
    pg_loss: torch.Tensor
    v_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    clipfrac: torch.Tensor


def ppo_terms(new_logp, old_logp, adv, tcfg: TrainConfig):
    """Clipped policy-gradient terms. All inputs (...,). Returns scalars
    (pg_loss, approx_kl, clipfrac)."""
    logratio = new_logp - old_logp
    ratio = torch.exp(logratio)
    pg1 = -adv * ratio
    pg2 = -adv * ratio.clamp(1 - tcfg.clip_coef, 1 + tcfg.clip_coef)
    pg_loss = torch.maximum(pg1, pg2).mean()
    approx_kl = ((ratio - 1.0) - logratio).mean()
    clipfrac = ((ratio - 1.0).abs() > tcfg.clip_coef).float().mean()
    return pg_loss, approx_kl, clipfrac


def value_loss(new_v, old_v, returns, tcfg: TrainConfig):
    if tcfg.vf_clip > 0:
        v_clipped = old_v + (new_v - old_v).clamp(-tcfg.vf_clip,
                                                  tcfg.vf_clip)
        vl = torch.maximum((new_v - returns).square(),
                           (v_clipped - returns).square())
    else:
        vl = (new_v - returns).square()
    return 0.5 * vl.mean()


def normalize_adv(adv, enabled: bool):
    """Minibatch advantage normalization with the population std (ddof 0,
    as ``jnp.std``; ``torch.std`` defaults to ddof 1)."""
    if not enabled:
        return adv
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def chunked_token_loss(backbone_params, hidden, actions, old_logp, adv,
                       cfg: ModelConfig, tcfg: TrainConfig,
                       chunk: int = 256):
    """Token-level PPO over an LM backbone without the full logits.

    hidden: (B, T, d); actions, old_logp, adv: (B, T). Returns (pg_loss,
    entropy, approx_kl, clipfrac), each summed over the chunks and divided
    by B·T. A chunk's logits are (B, chunk, vocab) f32; under autograd each
    chunk's terms run under ``checkpoint`` (in place of the reference's
    ``jax.checkpoint``), so only one chunk's logits live at a time in the
    forward and in the backward. ``gather`` picks the taken token's logit
    where the reference contracts a one-hot (kept there for a vocab-sharded
    layout the port does not have): the same value."""
    B, T, _ = hidden.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"T {T} is not a multiple of the loss chunk "
                         f"{chunk}")

    def chunk_terms(h_c, a_c, olp_c, adv_c):
        logits = tr.logits_from_hidden(backbone_params, h_c, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        tok = logits.gather(-1, a_c.long()[..., None])[..., 0]
        new_logp = tok - lse
        p = torch.softmax(logits, dim=-1)
        ent = lse - (p * logits).sum(-1)
        logratio = new_logp - olp_c
        ratio = torch.exp(logratio)
        pg1 = -adv_c * ratio
        pg2 = -adv_c * ratio.clamp(1 - tcfg.clip_coef, 1 + tcfg.clip_coef)
        return torch.stack([
            torch.maximum(pg1, pg2).sum(), ent.sum(),
            ((ratio - 1.0) - logratio).sum(),
            ((ratio - 1.0).abs() > tcfg.clip_coef).float().sum()])

    grad = torch.is_grad_enabled()
    total = torch.zeros(4, device=hidden.device)
    for c0 in range(0, T, chunk):
        args = tuple(x[:, c0:c0 + chunk]
                     for x in (hidden, actions, old_logp, adv))
        total = total + (checkpoint(chunk_terms, *args, use_reentrant=False,
                                    context_fn=dispatch.recompute_context)
                         if grad else chunk_terms(*args))
    pg, ent, kl, cf = total / float(B * T)
    return pg, ent, kl, cf
