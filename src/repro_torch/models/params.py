"""Parameter system: one spec tree gives the shapes, the init and the layout.

Modules declare nested dicts of ``ParamSpec``; ``init_params`` materialises
them as in ``repro/models/params.py``: ``normal / sqrt(fan_in)`` drawn in f32
and then cast, zeros, or ones, drawn from an explicit ``torch.Generator``.
``Params`` holds such a tree as an ``nn.Module`` whose parameter names follow
the spec's keys, so ``state_dict`` keys read ``layers.3.attn.wq``.

The sharding helpers of the JAX package (``constrain``, ``use_weight``,
logical-axis rules) are not ported: on one device they are no-ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"            # normal | zeros
    fan_in: Optional[int] = None    # for "normal": std = 1/sqrt(fan_in)
    dtype: Optional[torch.dtype] = None   # None => use param_dtype


def _leaves(spec_tree, prefix=()):
    for k, v in spec_tree.items():
        if isinstance(v, ParamSpec):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def init_params(spec_tree, generator: torch.Generator,
                param_dtype=torch.float32, device=None) -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``
    (default: the generator's device), drawing leaves in tree order."""
    device = torch.device(device) if device is not None else generator.device
    out: dict = {}
    for path, spec in _leaves(spec_tree):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            x = torch.zeros(spec.shape, dtype=dtype, device=device)
        else:
            fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                  else spec.shape[-1])
            x = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 / math.sqrt(fan)).to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(spec_tree))


class Params(nn.Module):
    """A nested dict of tensors as a module tree: ``p["wq"]`` reads a
    parameter, ``p["attn"]`` a sub-tree, as the JAX code reads its dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules
