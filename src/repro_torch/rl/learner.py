"""The Ocean PPO learner (Clean PuffeRL) on one device.

The counterpart of the Ocean half of ``repro/rl/learner.py``: rollout →
GAE → minibatched clipped-PPO epochs with AdamW. Recurrent policies
minibatch over envs and recompute hidden states through whole stored
sequences from the rollout's first carry, with per-step reset masking (the
LSTM-state handling the paper singles out as the common bug).

GAE goes through the kernel registry (``kernels.ops.gae``): the CUDA kernel
for CUDA tensors, the plain version on the CPU. The epoch permutations come
from the generator, or are given (``perms``) so that a test can feed the
reference's. Nothing here syncs with the host. The data-parallel layout
(``axis_name``, ``num_shards``) and the off-policy advantage (``adv_fn``,
V-trace) come with the data-parallel and async slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops as kops
from repro_torch.optim import adamw
from repro_torch.rl import ppo
from repro_torch.rl.rollout import RolloutCarry, Trajectory, rollout


class TrainState(NamedTuple):
    params: dict
    opt: adamw.AdamWState
    step: torch.Tensor


def init_train_state(params, state_dtype=torch.float32) -> TrainState:
    device = adamw.tree_leaves(params)[0].device
    return TrainState(params, adamw.init(params, state_dtype),
                      torch.zeros((), dtype=torch.int32, device=device))


def _check_divisible(n, M, num_envs, unroll_length, what):
    if n % M != 0:
        raise ValueError(
            f"{what} ({n}) is not divisible by num_minibatches={M} "
            f"(num_envs={num_envs}, unroll_length={unroll_length}); pick "
            f"num_envs / unroll_length so each PPO minibatch has the same "
            f"size")


def epoch_perms(generator: torch.Generator, n: int, epochs: int,
                minibatches: int) -> torch.Tensor:
    """(epochs·minibatches, n / minibatches) sample indices: one random
    permutation of ``range(n)`` per epoch, cut into minibatches. Drawn as
    the argsort of uniform keys, on the generator's device."""
    dev = generator.device
    return torch.cat([
        torch.argsort(torch.rand(n, generator=generator, device=dev))
        .reshape(minibatches, n // minibatches) for _ in range(epochs)])


def make_ocean_learn(policy, tcfg: TrainConfig, dist):
    """The post-rollout half of the update: GAE → minibatched clipped-PPO
    epochs. Returns ``learn(ts, carry0, traj, last_value, generator,
    perms=None) → (ts, metrics)``; ``metrics`` are 0-dim device tensors."""
    E, M = tcfg.update_epochs, tcfg.num_minibatches

    def learn(ts: TrainState, carry0, traj: Trajectory, last_value,
              generator: torch.Generator = None, perms=None):
        T, B = traj.rewards.shape
        # the kernel reads the (B, T) views through their strides
        adv = kops.gae(traj.rewards.T, traj.values.T, traj.dones.T,
                       last_value, tcfg.gamma, tcfg.gae_lambda).T  # (T, B)
        returns = adv + traj.values

        def terms(logits, newv, actions, logprobs, a, values, ret):
            newlogp = dist.log_prob(logits, actions)
            ent = dist.entropy(logits).mean()
            a = ppo.normalize_adv(a, tcfg.norm_adv)
            pg, kl, cf = ppo.ppo_terms(newlogp, logprobs, a, tcfg)
            vl = ppo.value_loss(newv, values, ret, tcfg)
            loss = pg - tcfg.ent_coef * ent + tcfg.vf_coef * vl
            return loss, ppo.PPOStats(pg, vl, ent, kl, cf)

        if policy.recurrent:
            # minibatch over envs; recompute through full sequences
            _check_divisible(B, M, B, T, "envs")
            n = B

            def loss_fn(params, idx):
                c0 = (tuple(c[idx] for c in carry0)
                      if carry0 is not None else None)
                logits, newv, _ = policy.seq(params, traj.obs[:, idx], c0,
                                             traj.resets[:, idx])
                return terms(logits, newv, traj.actions[:, idx],
                             traj.logprobs[:, idx], adv[:, idx],
                             traj.values[:, idx], returns[:, idx])
        else:
            # flat sample index t·B + env
            _check_divisible(T * B, M, B, T, "samples")
            n = T * B
            flat = lambda x: x.reshape((n,) + tuple(x.shape[2:]))
            obs, actions, logprobs, values, flat_adv, flat_ret = map(
                flat, (traj.obs, traj.actions, traj.logprobs, traj.values,
                       adv, returns))

            def loss_fn(params, idx):
                logits, newv, _ = policy.step(params, obs[idx], None)
                return terms(logits, newv, actions[idx], logprobs[idx],
                             flat_adv[idx], values[idx], flat_ret[idx])

        if perms is None:
            perms = epoch_perms(generator, n, E, M)
        for idx in perms:
            with torch.enable_grad():
                p = adamw.tree_map(lambda x: x.detach().requires_grad_(),
                                   ts.params)
                loss, stats = loss_fn(p, idx)
                leaves = iter(torch.autograd.grad(loss,
                                                  adamw.tree_leaves(p)))
            grads = adamw.tree_map(lambda _: next(leaves), p)
            params, opt, gstats = adamw.update(
                grads, ts.opt, ts.params, lr=tcfg.learning_rate,
                b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
                weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm)
            ts = TrainState(params, opt, ts.step + 1)

        # episode stats from the infos; the others are the last minibatch's
        valid = traj.infos["valid"]
        episodes = valid.sum().float()
        nv = episodes.clamp(min=1.0)
        metrics = {
            "loss": loss.detach(),
            "pg_loss": stats.pg_loss.detach(),
            "v_loss": stats.v_loss.detach(),
            "entropy": stats.entropy.detach(),
            "approx_kl": stats.approx_kl.detach(),
            "clipfrac": stats.clipfrac.detach(),
            "grad_norm": gstats["grad_norm"],
            "score": (traj.infos["score"] * valid).sum() / nv,
            "episode_return":
                (traj.infos["episode_return"] * valid).sum() / nv,
            "episodes": episodes,
        }
        return ts, metrics

    return learn


def make_ocean_update(policy, step_fn, tcfg: TrainConfig, dist):
    """Returns ``update(ts, rollout_carry, generator) → (ts, carry,
    metrics)``: one rollout of ``tcfg.unroll_length`` steps, then ``learn``
    from the carry the rollout started with. Its two halves are exposed as
    ``update.collect(ts, rc, generator) → (rc, (carry0, traj, last_value))``
    and ``update.learn(ts, carry0, traj, last_value, generator)``, so that
    each can be timed on its own."""
    learn = make_ocean_learn(policy, tcfg, dist)

    def collect(ts: TrainState, rc: RolloutCarry, generator):
        carry0 = rc.policy_carry
        rc, traj, last_value = rollout(policy, ts.params, step_fn, rc,
                                       generator, tcfg.unroll_length, dist)
        return rc, (carry0, traj, last_value)

    def update(ts: TrainState, rc: RolloutCarry, generator):
        rc, batch = collect(ts, rc, generator)
        ts, metrics = learn(ts, *batch, generator)
        return ts, rc, metrics

    update.collect, update.learn = collect, learn
    return update
