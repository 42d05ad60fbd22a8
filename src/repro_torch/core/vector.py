"""Vectorization — the paper's §3.3, one batched path.

The counterpart of ``repro/core/vector.py``'s ``vmap`` backend. All N env
states live in device tensors with a leading env axis, and one ``step`` call
steps them all (the envs are batched, see ``envs/base.py``), with auto-reset
inside the step: no host sync, and observations are never re-laid-out
between the env, the emulation layer and the model.

Multiagent envs are exposed agent-major: ``batch_size = N * num_agents``;
observations and rewards arrive as ``(N·A, …)``, ``done`` is each env's flag
repeated A times consecutively, and the infos stay per env, ``(N,)``.

The ``serial`` and ``shard`` backends and ``autotune`` are not ported: the
first serves host-bound envs (the host-tier slice), the second the
data-parallel slice.
"""
from __future__ import annotations

import torch


def tree_select(pred, on_true, on_false):
    """Branch-free select over nested dicts: ``pred`` (N,) bool picks along
    the leading axis of every leaf."""
    if isinstance(on_true, dict):
        return {k: tree_select(pred, on_true[k], on_false[k])
                for k in on_true}
    p = pred.reshape((-1,) + (1,) * (on_true.dim() - 1))
    return torch.where(p, on_true, on_false)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class VecEnv:
    """N copies of a (usually ``Emulated``) batched env, stepped as one
    batch with auto-reset: where ``done``, the state and observation are
    those of a fresh reset, which draws new randomness."""

    def __init__(self, env, num_envs: int):
        self.env, self.num_envs = env, num_envs
        self.num_agents = getattr(env, "num_agents", 1)
        self.batch_size = num_envs * self.num_agents
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space

    def init(self, generator: torch.Generator):
        state = self.env.init(self.num_envs, generator)
        return self.reset(state, generator)

    def reset(self, state, generator: torch.Generator):
        state, obs = self.env.reset(state, generator)
        return state, self._flatten_agents(obs)

    def step(self, state, actions, generator: torch.Generator):
        """actions: (N·A, …). Returns (state, obs (N·A, …), reward (N·A,),
        done (N·A,), info (N,))."""
        actions = self._unflatten_agents(actions)
        s2, obs, rew, done, info = self.env.step(state, actions, generator)
        s_reset, obs_reset = self.env.reset(s2, generator)
        state = tree_select(done, s_reset, s2)
        obs = tree_select(done, obs_reset, obs)
        return (state, self._flatten_agents(obs), self._flatten_rew(rew),
                self._broadcast_done(done), info)

    # -- agent-major reshapes --------------------------------------------------
    def _flatten_agents(self, obs):
        if self.num_agents == 1:
            return obs
        return _tree_map(
            lambda x: x.reshape((self.batch_size,) + tuple(x.shape[2:])), obs)

    def _unflatten_agents(self, actions):
        if self.num_agents == 1:
            return actions
        return _tree_map(
            lambda x: x.reshape((self.num_envs, self.num_agents)
                                + tuple(x.shape[1:])), actions)

    def _flatten_rew(self, rew):
        if self.num_agents == 1:
            return rew
        return rew.reshape(self.batch_size)

    def _broadcast_done(self, done):
        if self.num_agents == 1:
            return done
        return torch.repeat_interleave(done, self.num_agents)
