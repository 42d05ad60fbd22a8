"""Emulation — the paper's §3.1: make any structured env look like Atari.

The counterpart of ``repro/core/emulation.py``. A wrapped env presents a
flat f32 observation vector and a single (multi)discrete or flat Box action;
``unemulate`` is the exact inverse (up to the f32 promotion), applied in the
first line of a model's forward pass, so nothing is lost.

Only the model-facing ``"f32"`` mode is ported here: leaves promoted to f32
and concatenated. The ``"bytes"`` mode packs leaves into one uint8 buffer
for the host tiers with the ``pack`` kernel, and comes with that slice.
Leading batch dimensions are inferred per leaf from the static spec, so the
same functions serve one env, a batch of envs or a (T, B) trajectory.
"""
from __future__ import annotations

import torch

from repro_torch.core import spaces as sp
from repro_torch.core.emuspec import (ActionSpec, FlatSpec, LeafSpec,  # noqa: F401
                                      action_spec, flat_spec)


def _check_mode(spec: FlatSpec) -> None:
    if spec.mode != "f32":
        raise NotImplementedError(
            f"emulation mode {spec.mode!r} packs bytes for the host tiers; it "
            f"comes with the host-tier slice (the pack kernel). Use 'f32'.")


def emulate(spec: FlatSpec, tree) -> torch.Tensor:
    """Pack a (possibly batched) space element into one flat f32 tensor."""
    _check_mode(spec)
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
        parts.append(x.to(torch.float32).reshape(b + (-1,)))
    return torch.cat(parts, dim=-1)


def unemulate(spec: FlatSpec, flat: torch.Tensor):
    """Exact inverse of ``emulate`` — the first line of the model's forward
    pass (paper §3.1)."""
    _check_mode(spec)
    if flat.shape[-1] != spec.total:
        raise ValueError(f"flat obs has {flat.shape[-1]} elements, the spec "
                         f"{spec.total}")
    return _unflatten(spec, flat)


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
        _check_mode(self.obs_spec)
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
