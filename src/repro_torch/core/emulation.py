"""Emulation — the paper's §3.1: make any structured env look like Atari.

The counterpart of ``repro/core/emulation.py``. A wrapped env presents a
flat observation vector and a single (multi)discrete or flat Box action;
``unemulate`` is the exact inverse, applied in the first line of a model's
forward pass, so nothing is lost. Two modes, as in the reference:

  * ``"f32"``   — leaves promoted to f32 and concatenated: the model-facing
                  format (exact up to the f32 promotion).
  * ``"bytes"`` — every leaf bitcast to uint8 (bool as 0/1) and the rows
                  joined by ``kernels.ops.pack``: the hand-written kernel on
                  the card, ``torch.cat`` on the CPU. Lossless for every
                  dtype; ``unemulate`` bitcasts back (``view``), never casts.
                  It is the transport format of the host tier's act step.

Leading batch dimensions are inferred per leaf from the static spec, so the
same functions serve one env, a batch of envs or a (T, B) trajectory.

Contract note: JAX runs with x64 off, so a 64-bit leaf is 32 bits wide in
the reference's arrays while the spec counts 8 bytes; the port packs the 8
bytes its tensors hold. Parity with the reference holds for 8- and 32-bit
and bool leaves.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import spaces as sp
from repro_torch.core.emuspec import (ActionSpec, FlatSpec, LeafSpec,  # noqa: F401
                                      action_spec, flat_spec)
from repro_torch.kernels import ops


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """(…, n) leaf → (…, n · itemsize) uint8, by bitcast (bool → 0/1)."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.dtype == torch.uint8:
        return x
    return x.contiguous().view(torch.uint8)


def _from_u8(chunk: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    """(…, size) uint8 slice → the leaf of ``shape`` and numpy ``dtype``, by
    bitcast: ``view(dtype)`` on the last axis (bool: ``!= 0``)."""
    if np.dtype(dtype) == np.bool_:
        return chunk.reshape(shape) != 0
    if np.dtype(dtype) == np.uint8:
        return chunk.reshape(shape)
    # a fresh copy: the slice's byte offset need not be aligned to the dtype
    x = chunk.clone(memory_format=torch.contiguous_format)
    return x.view(sp.torch_dtype(dtype)).reshape(shape)


def emulate(spec: FlatSpec, tree) -> torch.Tensor:
    """Pack a (possibly batched) space element into one flat tensor: f32 in
    ``"f32"`` mode, uint8 in ``"bytes"`` mode (one ``ops.pack`` call over
    the leaves, any leading batch shape folded into its rows)."""
    parts, batch = [], None
    for ls in spec.leaf_specs:
        x = torch.as_tensor(sp.get_path(tree, ls.path))
        nb = x.dim() - len(ls.shape)
        if nb < 0:
            raise ValueError(f"leaf {ls.path}: got shape {tuple(x.shape)}, "
                             f"want {ls.shape}")
        b = tuple(x.shape[:nb])
        if batch is not None and batch != b:
            raise ValueError(f"inconsistent batch dims {batch} and {b}")
        batch = b
        if spec.mode == "bytes":
            n = math.prod(ls.shape)
            parts.append(_to_u8(x.reshape((math.prod(b), n))))
        else:
            parts.append(x.to(torch.float32).reshape(b + (-1,)))
    if spec.mode == "bytes":
        return ops.pack(parts).reshape(batch + (spec.total,))
    return torch.cat(parts, dim=-1)


def unemulate(spec: FlatSpec, flat: torch.Tensor):
    """Exact inverse of ``emulate`` — the first line of the model's forward
    pass (paper §3.1)."""
    if flat.shape[-1] != spec.total:
        raise ValueError(f"flat obs has {flat.shape[-1]} elements, the spec "
                         f"{spec.total}")
    if spec.mode != "bytes":
        return _unflatten(spec, flat)
    if flat.dtype != torch.uint8:
        raise TypeError(f"bytes-mode flat obs must be uint8, got "
                        f"{flat.dtype}")
    batch = tuple(flat.shape[:-1])
    tree = sp.zeros(spec.space)
    for ls in spec.leaf_specs:
        chunk = flat[..., ls.offset:ls.offset + ls.size]
        tree = sp.set_path(tree, ls.path,
                           _from_u8(chunk, batch + ls.shape, ls.dtype))
    return tree


# -- action emulation --------------------------------------------------------

def unemulate_action(spec: ActionSpec, flat: torch.Tensor):
    """(…, num_components) → original action tree."""
    return _unflatten(spec, flat)


def _unflatten(spec, flat: torch.Tensor):
    """Cut ``flat`` (…, total) at the spec's leaf offsets into its tree."""
    batch = tuple(flat.shape[:-1])
    tree = sp.zeros(spec.space)
    for ls in spec.leaf_specs:
        chunk = flat[..., ls.offset:ls.offset + ls.size]
        leaf = chunk.reshape(batch + ls.shape).to(sp.torch_dtype(ls.dtype))
        tree = sp.set_path(tree, ls.path, leaf)
    return tree


def emulate_action(spec: ActionSpec, tree) -> torch.Tensor:
    out_dtype = torch.int32 if spec.kind == "discrete" else torch.float32
    parts = []
    for ls in spec.leaf_specs:
        x = torch.as_tensor(sp.get_path(tree, ls.path)).to(out_dtype)
        nb = x.dim() - len(ls.shape)
        parts.append(x.reshape(tuple(x.shape[:nb]) + (-1,)))
    return torch.cat(parts, dim=-1)


# -- environment wrapper ------------------------------------------------------

class Emulated:
    """``env = Emulated(env)`` makes a batched structured env look like
    Atari (flat Box obs, MultiDiscrete or flat Box action) to everything
    downstream. Observations stay agent-major in canonical order; the
    shapes are checked on the first batch only."""

    def __init__(self, env, mode: str = "f32"):
        self.env = env
        self.obs_spec = flat_spec(env.observation_space, mode)
        self.act_spec = action_spec(env.action_space)
        self.num_agents = getattr(env, "num_agents", 1)
        self.observation_space = sp.Box((self.obs_spec.total,),
                                        self.obs_spec.dtype)
        self.action_space = (sp.MultiDiscrete(self.act_spec.nvec)
                             if self.act_spec.kind == "discrete"
                             else sp.Box((self.act_spec.cont_dim,)))
        self._checked = False

    # batched env protocol (see envs/base.py)
    def init(self, num_envs: int, generator: torch.Generator):
        return self.env.init(num_envs, generator)

    def reset(self, state, generator: torch.Generator):
        state, obs = self.env.reset(state, generator)
        return state, self._obs(obs)

    def step(self, state, action, generator: torch.Generator):
        action = unemulate_action(self.act_spec, action)
        state, obs, rew, done, info = self.env.step(state, action, generator)
        return state, self._obs(obs), rew, done, info

    def _obs(self, obs):
        flat = emulate(self.obs_spec, obs)
        if not self._checked:   # paper: check shapes on the first batch only
            want = ((self.num_agents, self.obs_spec.total)
                    if self.num_agents > 1 else (self.obs_spec.total,))
            if tuple(flat.shape[-len(want):]) != want:
                raise ValueError(f"emulated obs {tuple(flat.shape)}, want "
                                 f"(..., {want})")
            self._checked = True
        return flat

    def unemulate_obs(self, flat):
        """First line of your model's forward pass."""
        return unemulate(self.obs_spec, flat)


def pad_agents(obs, mask, num_agents: int, axis: int = 0):
    """Pad agent-major data to a fixed agent count (paper §3.1). ``mask``
    marks live agents; padded rows are zero. The agent axis is ``axis`` of
    ``obs`` and the last axis of ``mask``: 0 for one env's ``(A, …)`` rows,
    as in the reference, or 1 for a batch of envs' ``(N, A, …)``."""
    cur = obs.shape[axis]
    if cur == num_agents:
        return obs, mask
    pad = list(obs.shape)
    pad[axis] = num_agents - cur
    mpad = tuple(mask.shape[:-1]) + (num_agents - cur,)
    return (torch.cat([obs, obs.new_zeros(pad)], dim=axis),
            torch.cat([mask, mask.new_zeros(mpad)], dim=-1))
