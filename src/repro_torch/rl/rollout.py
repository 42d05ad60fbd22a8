"""Rollout: the paper's actor loop, T policy and env steps on the device.

The counterpart of ``repro/rl/rollout.py``. The JAX rollout is one fused
``scan``; here it is a Python loop whose every step enqueues device work
only — policy step, sampling, env step with auto-reset — so a rollout never
syncs with the host. Each stored step holds the observation from *before*
the step and ``resets = done_prev`` (that observation began an episode).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.vector import blocks


class Trajectory(NamedTuple):
    obs: torch.Tensor        # (T, B, obs)
    actions: torch.Tensor    # (T, B, n_comp)
    logprobs: torch.Tensor   # (T, B)
    values: torch.Tensor     # (T, B)
    rewards: torch.Tensor    # (T, B)
    dones: torch.Tensor      # (T, B)  done AT this step
    resets: torch.Tensor     # (T, B)  obs at this step began an episode
    infos: dict              # (T, num_envs) per key


class RolloutCarry(NamedTuple):
    env_state: object
    obs: torch.Tensor
    policy_carry: object
    done_prev: torch.Tensor


def sample(dist, generator, logits):
    """``dist.sample`` over the rows of ``logits``, by block when
    ``generator`` is a list (the rows split into as many contiguous
    blocks)."""
    gens = blocks(generator)
    if gens is None:
        return dist.sample(generator, logits)
    return torch.cat([dist.sample(g, x)
                      for g, x in zip(gens, logits.chunk(len(gens)))])


@torch.no_grad()
def rollout(policy, params, step_fn, carry: RolloutCarry,
            generator: torch.Generator, unroll: int, dist):
    """Returns (carry', Trajectory, last_value (B,)). ``step_fn(state,
    actions, generator)`` is a ``VecEnv.step``; ``dist`` a
    distributions.Dist; ``generator`` one generator or one per block."""
    steps = []
    c = carry
    for _ in range(unroll):
        logits, value, pc = policy.step(params, c.obs, c.policy_carry,
                                        reset=c.done_prev)
        action = sample(dist, generator, logits)
        logp = dist.log_prob(logits, action)
        env_state, obs, rew, done, info = step_fn(c.env_state, action,
                                                  generator)
        steps.append((c.obs, action, logp, value, rew, done, c.done_prev,
                      info))
        c = RolloutCarry(env_state, obs, pc, done)
    cols = list(zip(*steps))
    traj = Trajectory(*(torch.stack(x) for x in cols[:7]),
                      infos={k: torch.stack([i[k] for i in cols[7]])
                             for k in cols[7][0]})
    # bootstrap value for GAE
    _, last_value, _ = policy.step(params, c.obs, c.policy_carry,
                                   reset=c.done_prev)
    return c, traj, last_value
