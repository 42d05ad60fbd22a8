"""Batched environment protocol.

The counterpart of ``repro/envs/base.py``. The JAX envs step one instance
and are ``vmap``ped; eager PyTorch per env would cost thousands of launches
per step, so the port's envs step a whole batch along a leading env axis:

  init(num_envs, generator)       -> state
  reset(state, generator)         -> (state, obs)
  step(state, action, generator)  -> (state, obs, reward, done, info)

``state`` is a dict of ``(N, …)`` tensors on the generator's device, and all
randomness comes from the generator. ``info`` is a fixed-shape dict of
``(N,)`` tensors with a validity flag, set only where ``done``. Multiagent
envs return agent-major ``(N, A, …)`` arrays in canonical order; ``done`` is
episode-scoped, ``(N,)``.

No method syncs with the host: constants live on the device (built once per
device, see ``OceanEnv.consts``), and branches are ``torch.where`` selects.
"""
from __future__ import annotations

import torch


def end_info(done, ep_return, t, score) -> dict:
    """Episode-end info: the values where ``done``, zeros elsewhere."""
    return {
        "score": torch.where(done, score, 0.0).float(),
        "episode_return": torch.where(done, ep_return, 0.0).float(),
        "episode_length": torch.where(done, t, 0).int(),
        "valid": done,
    }


class OceanEnv:
    """Base of the batched Ocean envs: per-device constants (from the
    subclass's ``make_consts(device)``), built once, and ``reset``."""

    num_agents = 1

    def consts(self, device: torch.device) -> dict:
        cache = self.__dict__.setdefault("_consts", {})
        if device not in cache:
            cache[device] = self.make_consts(device)
        return cache[device]

    def reset(self, state, generator: torch.Generator):
        s = self.init(state["t"].shape[0], generator)
        return s, self.obs(s)
