"""AdamW as plain functions on nested dicts of tensors.

The counterpart of ``repro/optim/adamw.py`` on one device: global-norm
clipping first (``grad_norm`` is reported before clipping), then the moment
updates, bias correction with the step count, and weight decay added to the
update. The step count is a device tensor, so an update never syncs with
the host. Defaults follow ``TrainConfig`` (``b2`` 0.95), not torch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def tree_leaves(tree) -> list:
    """Leaves of a nested dict of tensors, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and of same-shaped
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def init(params, state_dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                  device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step, tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.0, max_grad_norm=0.0):
    """Returns (new_params, new_state, stats)."""
    gnorm = global_norm(grads)
    if max_grad_norm:
        scale = (max_grad_norm / gnorm.clamp(min=1e-12)).clamp(max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p2 = p.float() - lr * u
        return p2.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)
    return (_pick(out, 0), AdamWState(step, _pick(out, 1), _pick(out, 2)),
            {"grad_norm": gnorm})


def _pick(tree, i):
    """Component ``i`` of every (p, m, v) leaf triple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
