"""PPO objective (Clean PuffeRL): the clipped policy-gradient terms, the
clipped value loss and minibatch advantage normalization.

The counterpart of ``repro/rl/ppo.py`` on one device. ``chunked_token_loss``
(the LM-backbone loss) comes with the LM-training slice, and the
data-parallel statistics of ``normalize_adv`` with the data-parallel one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig


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
