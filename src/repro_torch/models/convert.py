"""Load the JAX package's parameters into the port, name for name.

``ocean_params_from_jax(tree)`` takes the tree ``repro``'s ``OceanPolicy.init``
returns, as numpy arrays, and gives the port's ``OceanPolicy`` parameter
dict: the same keys and layouts, except the conv kernel, HWIO ``(3, 3, 1, 8)``
in JAX and OIHW ``(8, 1, 3, 3)`` in the port.

``params_from_jax(tree)`` takes the tree ``repro``'s ``BackbonePolicy.init``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), and gives a
``state_dict`` for the port's ``BackbonePolicy``. The stacked
``(n_periods, …)`` leading axis of every layer parameter is unstacked: entry
``p`` of ``layers/l{i}`` becomes ``layers.{p * period + i}``, where
``period`` is the number of ``l{i}`` keys. Layouts are otherwise the same.

bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects; they go through their 16-bit pattern, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(a) -> torch.Tensor:
    """numpy array → CPU tensor; bf16 is moved bit-exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, name + ".", out)
        else:
            out[name] = to_torch(v)


def params_from_jax(tree: dict) -> dict:
    """JAX ``BackbonePolicy`` parameter tree (numpy leaves) → port
    ``state_dict`` (CPU tensors, the JAX dtypes)."""
    out: dict = {}
    backbone = dict(tree["backbone"])
    stacked = backbone.pop("layers")
    _flatten(backbone, "backbone.", out)
    period = len(stacked)
    for i in range(period):
        sub = stacked[f"l{i}"]
        n_periods = len(next(iter(_leaves(sub))))
        for p in range(n_periods):
            layer = _map(sub, lambda a, p=p: np.asarray(a)[p])
            _flatten(layer, f"backbone.layers.{p * period + i}.", out)
    for k, v in tree.items():
        if k != "backbone":
            _flatten({k: v}, "", out)
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def ocean_params_from_jax(tree: dict) -> dict:
    """JAX ``OceanPolicy`` parameter tree (numpy leaves) → port parameter
    dict (CPU tensors)."""
    out = _map(tree, to_torch)
    if "conv" in out:
        out["conv"] = out["conv"].permute(3, 2, 0, 1).contiguous()
    return out
