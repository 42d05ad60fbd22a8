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
``period`` is the number of ``l{i}`` keys. Layouts are otherwise the same,
the Mamba2 leaves included: ``ssm.in_proj``, ``conv_w`` and ``out_proj`` in
the parameter dtype, ``ssm.A_log``, ``D``, ``dt_bias`` and ``norm`` in f32;
and the MoE leaves: ``moe.router`` (d, E) in f32, ``moe.wi`` (E, d, 2f) and
``moe.wo`` (E, f, d) in the parameter dtype (jamba's period is 8: attention
every 8th layer, MoE every 2nd).

``backbone_tree_from_jax(tree)`` gives the same parameters as the plain
nested dict that ``BackbonePolicy.params()`` returns and the learner trains
(``{"backbone": {"layers": {"0": …}, …}, "value": …}``), and
``train_state_from_jax(state)`` turns the reference's LM ``TrainState``
(``repro.rl.learner.init_train_state``; params, AdamW moments laid out like
them, step counts) into the port's, so that both packages train from the
same numbers.

``shard_tree(tree, pspecs, plan)`` and ``gather_tree(tree, pspecs, plan)``
move a parameter tree (or one laid out like it: AdamW's moments) between
its global form and one rank's blocks on a mesh (``distributed/plan.py``):
the layout of ``BackbonePolicy(cfg, mesh=)`` and of a sharded checkpoint.

bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects; they go through their 16-bit pattern, bit for bit. A quantised tree
(``repro.models.params.quantize_params``) loads into a ``BackbonePolicy``
built with the same ``quantize``: int8 leaves as they are, ``ml_dtypes``
int4 leaves as int8 values packed two to a byte (``kernels/ref.py::
pack_int4``), and each ``<name>_scale``, (n_periods, last) per layer leaf,
unstacked like the rest: an expert leaf's scale is one (2f,) or (d,)
vector a layer, shared across its experts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import pack_int4


def to_torch(a) -> torch.Tensor:
    """numpy array → CPU tensor; bf16 is moved bit-exactly, int4 packed
    two to a uint8 along its last axis."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "int4":
        return pack_int4(torch.from_numpy(a.astype(np.int8)))
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


def nest(flat: dict) -> dict:
    """``{"a.b.c": x}`` → ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for name, x in flat.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def backbone_tree_from_jax(tree: dict) -> dict:
    """JAX ``BackbonePolicy`` parameter tree (numpy leaves) → the port's
    plain parameter tree (CPU tensors, the JAX dtypes), layers unstacked."""
    return nest(params_from_jax(tree))


def train_state_from_jax(state):
    """The reference's LM ``TrainState`` (numpy leaves: ``params``, ``opt``
    with ``step``, ``m``, ``v``, and ``step``) → the port's
    ``rl.learner.TrainState`` on the CPU."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.rl.learner import TrainState

    def step(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32).copy())

    opt = state.opt
    return TrainState(backbone_tree_from_jax(state.params),
                      AdamWState(step(opt.step),
                                 backbone_tree_from_jax(opt.m),
                                 backbone_tree_from_jax(opt.v)),
                      step(state.step))


def shard_tree(tree: dict, pspecs: dict, plan) -> dict:
    """This rank's block of every global leaf of ``tree``."""
    from repro_torch.distributed.plan import shard
    return {k: shard_tree(v, pspecs[k], plan) if isinstance(v, dict)
            else shard(v, pspecs[k], plan) for k, v in tree.items()}


def gather_tree(tree: dict, pspecs: dict, plan) -> dict:
    """Every global leaf from the ranks' blocks ``tree``, on every rank.
    Collective: every rank of the plan's mesh calls it."""
    from repro_torch.distributed.plan import unshard
    return {k: gather_tree(v, pspecs[k], plan) if isinstance(v, dict)
            else unshard(v, pspecs[k], plan) for k, v in tree.items()}


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
