"""Policy-output distributions: a factored MultiDiscrete categorical over one
concatenated logit vector, and a diagonal Gaussian for continuous actions.

The counterpart of ``repro/rl/distributions.py``. The emulation layer turns
every discrete action tree into one MultiDiscrete; the policy emits one
``(…, sum(nvec))`` logit vector, and joint log-prob and entropy are sums
over the components, each a log-softmax in f32 over its static segment.
Sampling draws from a ``torch.Generator`` (Gumbel-max for the categorical),
so it never syncs with the host.
"""
from __future__ import annotations

import math

import torch

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
_TINY = torch.finfo(torch.float32).tiny


def _segments(nvec):
    off = 0
    for n in nvec:
        yield off, n
        off += n


def sample(generator, logits, nvec):
    """logits: (…, sum(nvec)) → actions (…, len(nvec)) int32, by Gumbel-max
    per segment."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=_TINY)))
    z = logits.float() + gumbel
    outs = [z[..., off:off + n].argmax(-1) for off, n in _segments(nvec)]
    return torch.stack(outs, dim=-1).int()


def log_prob(logits, actions, nvec):
    """actions: (…, len(nvec)); returns (…)."""
    total = 0.0
    for i, (off, n) in enumerate(_segments(nvec)):
        lp = torch.log_softmax(logits[..., off:off + n].float(), dim=-1)
        total = total + lp.gather(-1, actions[..., i:i + 1].long())[..., 0]
    return total


def entropy(logits, nvec):
    total = 0.0
    for off, n in _segments(nvec):
        lp = torch.log_softmax(logits[..., off:off + n].float(), dim=-1)
        total = total + -(lp.exp() * lp).sum(-1)
    return total


def mode(logits, nvec):
    outs = [logits[..., off:off + n].argmax(-1) for off, n in _segments(nvec)]
    return torch.stack(outs, dim=-1).int()


# -- diagonal Gaussian (continuous actions) -----------------------------------

def gaussian_sample(generator, out, cont_dim: int):
    """out: (…, 2·cont_dim) = [mean ‖ log_std] from the policy head."""
    mean, log_std = out[..., :cont_dim], out[..., cont_dim:]
    noise = torch.randn(mean.shape, generator=generator, device=out.device)
    return mean + torch.exp(log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)) * noise


def gaussian_log_prob(out, actions, cont_dim: int):
    mean, log_std = out[..., :cont_dim], out[..., cont_dim:]
    log_std = log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)
    z = (actions - mean) * torch.exp(-log_std)
    return (-0.5 * z.square() - log_std
            - 0.5 * math.log(2 * math.pi)).sum(-1)


def gaussian_entropy(out, cont_dim: int):
    log_std = out[..., cont_dim:].clamp(LOG_STD_MIN, LOG_STD_MAX)
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


class Dist:
    """One object the rollout and the learner use whatever the action kind
    (MultiDiscrete categorical or continuous Gaussian)."""

    def __init__(self, kind: str, nvec=(), cont_dim: int = 0):
        if kind not in ("categorical", "gaussian"):
            raise ValueError(f"unknown distribution kind {kind!r}")
        self.kind, self.nvec, self.cont_dim = kind, tuple(nvec), cont_dim
        self.num_outputs = (sum(self.nvec) if kind == "categorical"
                            else 2 * cont_dim)
        # action components per agent row, and their dtype's name
        self.action_dim = (len(self.nvec) if kind == "categorical"
                           else cont_dim)
        self.action_dtype = "int32" if kind == "categorical" else "float32"

    def sample(self, generator, out):
        if self.kind == "categorical":
            return sample(generator, out, self.nvec)
        return gaussian_sample(generator, out, self.cont_dim)

    def log_prob(self, out, actions):
        if self.kind == "categorical":
            return log_prob(out, actions, self.nvec)
        return gaussian_log_prob(out, actions, self.cont_dim)

    def entropy(self, out):
        if self.kind == "categorical":
            return entropy(out, self.nvec)
        return gaussian_entropy(out, self.cont_dim)
