"""The PPO learners (Clean PuffeRL) on one device: Ocean and LM backbone.

The counterpart of ``repro/rl/learner.py``. The Ocean half: rollout →
GAE → minibatched clipped-PPO epochs with AdamW. Recurrent policies
minibatch over envs and recompute hidden states through whole stored
sequences from the rollout's first carry, with per-step reset masking (the
LSTM-state handling the paper singles out as the common bug).

GAE goes through the kernel registry (``kernels.ops.gae``): the CUDA kernel
for CUDA tensors, the plain version on the CPU. The epoch permutations come
from the generator, or are given (``perms``) so that a test can feed the
reference's. Nothing here syncs with the host. ``adv_fn`` replaces GAE
with an off-policy advantage (``make_vtrace_adv``, the async tier's
V-trace). The data-parallel layout: ``group`` (a process group, where the
reference has ``axis_name``) makes each rank learn from its own env block
with the gradients averaged over the ranks; ``num_shards`` S without a
group emulates that S-block layout in one process (``make_ocean_learn``).

The LM-backbone half (``lm_batch_fields``, ``make_lm_train_step``): one PPO
update on a token rollout through ``BackbonePolicy``'s functional path,
the backbone's layers recomputed in the backward (``cfg.remat``) and the
loss taken chunk by chunk (``ppo.chunked_token_loss``). On the card the
backward runs through the attention and SSD backward kernels
(``kernels/flash_attention.py``, ``kernels/ssd.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.vector import blocks
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw, schedule
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
            f"(num_envs={num_envs}, num_minibatches={M}, "
            f"unroll_length={unroll_length}); pick num_envs / unroll_length "
            f"so each PPO minibatch has the same size")


def epoch_perms(generator: torch.Generator, n: int, epochs: int,
                minibatches: int) -> torch.Tensor:
    """(epochs·minibatches, n / minibatches) sample indices: one random
    permutation of ``range(n)`` per epoch, cut into minibatches. Drawn as
    the argsort of uniform keys, on the generator's device."""
    dev = generator.device
    return torch.cat([
        torch.argsort(torch.rand(n, generator=generator, device=dev))
        .reshape(minibatches, n // minibatches) for _ in range(epochs)])


def make_vtrace_adv(policy, dist, tcfg: TrainConfig,
                    rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace advantages and value targets (IMPALA) for the async tier's
    off-policy fragments: truncated importance weights correct for the
    policy-version lag between the actor that produced a fragment and the
    learner consuming it. Plugs into ``make_ocean_learn(adv_fn=...)``.

    rho and c are exp(logpi_current − logpi_behavior) per sample, clamped
    at ``rho_clip`` / ``c_clip``; on-policy fragments give rho = c = 1. The
    reverse recursion over T is a plain loop (a ``lax.scan`` in the
    reference, not a Pallas kernel). Non-recurrent policies only: the
    fragment slab ships no carries."""
    if policy.recurrent:
        raise ValueError("make_vtrace_adv supports non-recurrent policies "
                         "(fragments carry no recurrent state)")

    @torch.no_grad()
    def adv_fn(params, traj: Trajectory, last_value):
        # one forward pass under the *current* policy over the whole batch
        logits, values, _ = policy.seq(params, traj.obs, None, traj.resets)
        newlogp = dist.log_prob(logits, traj.actions)
        rho = torch.exp(newlogp - traj.logprobs)
        rho_c = rho.clamp(max=rho_clip)
        c = rho.clamp(max=c_clip)
        nd = 1.0 - traj.dones.float()            # no bootstrap across
        v_next = torch.cat([values[1:], last_value[None]])
        delta = rho_c * (traj.rewards + tcfg.gamma * v_next * nd - values)
        acc = torch.zeros_like(last_value)
        out = []
        for t in range(delta.shape[0] - 1, -1, -1):
            acc = delta[t] + tcfg.gamma * nd[t] * c[t] * acc
            out.append(acc)
        vs = values + torch.stack(out[::-1])
        vs_next = torch.cat([vs[1:], last_value[None]])
        adv = rho_c * (traj.rewards + tcfg.gamma * vs_next * nd - values)
        # both are fixed targets for the PPO epochs (from pre-update params)
        return adv, vs

    return adv_fn


def make_ocean_learn(policy, tcfg: TrainConfig, dist, adv_fn=None,
                     num_shards: int = 1, group=None):
    """The post-rollout half of the update: GAE → minibatched clipped-PPO
    epochs. Returns ``learn(ts, carry0, traj, last_value, generator,
    perms=None) → (ts, metrics)``; ``metrics`` are 0-dim device tensors.
    ``adv_fn(params, traj, last_value) → (adv, returns)`` replaces GAE
    (``make_vtrace_adv``), computed once per update from the pre-update
    params, where GAE runs.

    ``group`` — a process group of S ranks, each holding its own block of
    B/S envs (``traj``, ``carry0`` and ``last_value`` are this rank's).
    Each rank draws its block's permutations from its generator; after each
    minibatch's backward one all-reduce averages the gradients, the loss
    and the stats over the ranks, before the same AdamW step on every rank;
    advantage normalization takes the global minibatch's statistics, and
    ``score``, ``episode_return`` and ``episodes`` come from sums over the
    ranks. So every rank's metrics are the same.

    ``num_shards`` — S without a group: one process emulates the S-block
    layout. ``generator`` is then a list of S (block s's), envs are
    permuted within S contiguous blocks, and global minibatch m is the
    union of every block's m-th slice (the reference's ``to_global``), so
    the update is the S-rank run's up to the order of float sums. S = 1
    is the plain one-device learn."""
    E, M = tcfg.update_epochs, tcfg.num_minibatches
    S = (num_shards if group is None
         else torch.distributed.get_world_size(group))

    def learn(ts: TrainState, carry0, traj: Trajectory, last_value,
              generator: torch.Generator = None, perms=None):
        T, B = traj.rewards.shape                      # this rank's shapes
        B_global = B * S if group is not None else B
        n_block = B if group is not None else B // S
        if adv_fn is None:
            # the kernel reads the (B, T) views through their strides
            adv = kops.gae(traj.rewards.T, traj.values.T, traj.dones.T,
                           last_value, tcfg.gamma, tcfg.gae_lambda).T
            returns = adv + traj.values                         # (T, B)
        else:
            adv, returns = adv_fn(ts.params, traj, last_value)

        def terms(logits, newv, actions, logprobs, a, values, ret):
            newlogp = dist.log_prob(logits, actions)
            ent = dist.entropy(logits).mean()
            a = ppo.normalize_adv(a, tcfg.norm_adv, group)
            pg, kl, cf = ppo.ppo_terms(newlogp, logprobs, a, tcfg)
            vl = ppo.value_loss(newv, values, ret, tcfg)
            loss = pg - tcfg.ent_coef * ent + tcfg.vf_coef * vl
            return loss, ppo.PPOStats(pg, vl, ent, kl, cf)

        if policy.recurrent:
            # minibatch over envs; recompute through full sequences
            _check_divisible(n_block, M, B_global, T,
                             f"envs per data shard ({S} shards)")
            n_loc = n_block
            to_global = lambda p, s: s * n_block + p

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
            _check_divisible(T * n_block, M, B_global, T,
                             f"samples per data shard ({S} shards)")
            n_loc = T * n_block
            # block-local flat index t·n_block + e → global t·B + env
            to_global = lambda p, s: ((p // n_block) * B + s * n_block
                                      + p % n_block)
            flat = lambda x: x.reshape((T * B,) + tuple(x.shape[2:]))
            obs, actions, logprobs, values, flat_adv, flat_ret = map(
                flat, (traj.obs, traj.actions, traj.logprobs, traj.values,
                       adv, returns))

            def loss_fn(params, idx):
                logits, newv, _ = policy.step(params, obs[idx], None)
                return terms(logits, newv, actions[idx], logprobs[idx],
                             flat_adv[idx], values[idx], flat_ret[idx])

        if perms is None:
            gens = blocks(generator)
            if gens is None:
                perms = epoch_perms(generator, n_loc, E, M)
            else:
                # each block's permutations from its generator, mapped to
                # global indices: minibatch m joins every block's m-th slice
                perms = torch.cat([to_global(epoch_perms(g, n_loc, E, M), s)
                                   for s, g in enumerate(gens)], dim=1)
        for idx in perms:
            with torch.enable_grad():
                p = adamw.tree_map(lambda x: x.detach().requires_grad_(),
                                   ts.params)
                loss, stats = loss_fn(p, idx)
                leaves = list(torch.autograd.grad(loss,
                                                  adamw.tree_leaves(p)))
            loss, stats = loss.detach(), ppo.PPOStats(
                *(x.detach() for x in stats))
            if group is not None:
                # one all-reduce: the gradients, the loss and the stats
                out = shd.allreduce_mean(
                    leaves + [loss.reshape(1), torch.stack(stats)], group)
                leaves, loss = out[:-2], out[-2][0]
                stats = ppo.PPOStats(*out[-1].unbind())
            leaves = iter(leaves)
            grads = adamw.tree_map(lambda _: next(leaves), p)
            params, opt, gstats = adamw.update(
                grads, ts.opt, ts.params, lr=tcfg.learning_rate,
                b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
                weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm)
            ts = TrainState(params, opt, ts.step + 1)

        # episode stats from the infos; the others are the last minibatch's
        valid = traj.infos["valid"]
        sums = [(traj.infos["score"] * valid).sum(),
                (traj.infos["episode_return"] * valid).sum(),
                valid.sum().float()]
        if group is not None:
            sums = shd.allreduce_sum(torch.stack(sums), group).unbind()
        score, ret, episodes = sums
        nv = episodes.clamp(min=1.0)
        metrics = {
            "loss": loss,
            "pg_loss": stats.pg_loss,
            "v_loss": stats.v_loss,
            "entropy": stats.entropy,
            "approx_kl": stats.approx_kl,
            "clipfrac": stats.clipfrac,
            "grad_norm": gstats["grad_norm"],
            "score": score / nv,
            "episode_return": ret / nv,
            "episodes": episodes,
        }
        return ts, metrics

    return learn


def make_ocean_update(policy, step_fn, tcfg: TrainConfig, dist,
                      num_shards: int = 1, group=None):
    """Returns ``update(ts, rollout_carry, generator) → (ts, carry,
    metrics)``: one rollout of ``tcfg.unroll_length`` steps, then ``learn``
    from the carry the rollout started with. Its two halves are exposed as
    ``update.collect(ts, rc, generator) → (rc, (carry0, traj, last_value))``
    and ``update.learn(ts, carry0, traj, last_value, generator)``, so that
    each can be timed on its own. ``num_shards`` and ``group`` are
    ``make_ocean_learn``'s (with S > 1 and no group, ``generator`` is a
    list of S)."""
    learn = make_ocean_learn(policy, tcfg, dist, num_shards=num_shards,
                             group=group)

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


# =============================== LM backbone =================================

def lm_batch_fields(cfg: ModelConfig, batch_size: int, seq_len: int):
    """(shape, torch dtype) of each field of one LM PPO rollout batch, as
    ``repro/rl/learner.py::lm_batch_fields`` gives them (``prefix`` for
    archs with a frontend)."""
    P = cfg.frontend_prefix if cfg.frontend else 0
    f = {
        "tokens": ((batch_size, seq_len - P), torch.int32),
        "actions": ((batch_size, seq_len), torch.int32),
        "old_logprob": ((batch_size, seq_len), torch.float32),
        "old_values": ((batch_size, seq_len), torch.float32),
        "rewards": ((batch_size, seq_len), torch.float32),
        "dones": ((batch_size, seq_len), torch.bool),
        "last_value": ((batch_size,), torch.float32),
    }
    if P:
        f["prefix"] = ((batch_size, P, cfg.d_model), torch.bfloat16)
    return f


def _value_and_grad(loss_fn, params, batch):
    """(loss, stats, grads) of ``loss_fn(params, batch)``, the gradients in
    the params' tree and dtypes."""
    with torch.enable_grad():
        p = adamw.tree_map(lambda x: x.detach().requires_grad_(), params)
        loss, stats = loss_fn(p, batch)
        grads = iter(torch.autograd.grad(loss, adamw.tree_leaves(p)))
    grads = adamw.tree_map(lambda _: next(grads), p)
    return loss.detach(), {k: v.detach() for k, v in stats.items()}, grads


def make_lm_train_step(policy, tcfg: TrainConfig, total_steps: int = 10_000,
                       loss_chunk: int = 256, num_microbatches: int = 1):
    """One PPO update on a token rollout:
    ``train_step(ts, batch) → (ts, metrics)``, ``metrics`` 0-dim device
    tensors (nothing syncs with the host).

    GAE runs through ``kops.gae`` once per loss evaluation, without a
    gradient (the advantages are constants of the batch); the loss is the
    clipped token-level PPO term of ``ppo.chunked_token_loss``, the value
    loss and ``0.01 · moe_aux``. ``num_microbatches > 1`` accumulates f32
    gradients over that many slices of the batch, as the reference's scan
    does. The rate is ``warmup_cosine`` of the state's step, then AdamW
    with ``tcfg.max_grad_norm``."""
    cfg = policy.cfg

    def loss_fn(params, batch):
        hidden, aux = tr.forward(params["backbone"], batch["tokens"], cfg,
                                 prefix=batch.get("prefix"))
        values = policy._value(params, hidden)                 # (B, T)
        with torch.no_grad():
            adv = kops.gae(batch["rewards"], batch["old_values"],
                           batch["dones"], batch["last_value"], tcfg.gamma,
                           tcfg.gae_lambda)
            returns = adv + batch["old_values"]
            adv = ppo.normalize_adv(adv, tcfg.norm_adv)
        pg, ent, kl, cf = ppo.chunked_token_loss(
            params["backbone"], hidden, batch["actions"],
            batch["old_logprob"], adv, cfg, tcfg, chunk=loss_chunk)
        vl = ppo.value_loss(values, batch["old_values"], returns, tcfg)
        loss = (pg - tcfg.ent_coef * ent + tcfg.vf_coef * vl
                + 0.01 * aux["moe_aux"])
        return loss, {"pg_loss": pg, "v_loss": vl, "entropy": ent,
                      "approx_kl": kl, "clipfrac": cf,
                      "moe_aux": aux["moe_aux"]}

    def train_step(ts: TrainState, batch):
        m = num_microbatches
        if m > 1:
            n = next(iter(batch.values())).shape[0]
            if n % m:
                raise ValueError(f"batch {n} is not divisible by "
                                 f"num_microbatches={m}")
            size = n // m
            gacc = adamw.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), ts.params)
            losses, all_stats = [], []
            for i in range(m):
                one = {k: v[i * size:(i + 1) * size]
                       for k, v in batch.items()}
                loss, stats, g = _value_and_grad(loss_fn, ts.params, one)
                gacc = adamw.tree_map(lambda a, b: a + b.float(), gacc, g)
                losses.append(loss)
                all_stats.append(stats)
            grads = adamw.tree_map(lambda g: g / m, gacc)
            loss = torch.stack(losses).mean()
            stats = {k: torch.stack([s[k] for s in all_stats]).mean()
                     for k in all_stats[0]}
        else:
            loss, stats, grads = _value_and_grad(loss_fn, ts.params, batch)
        lr = schedule.warmup_cosine(ts.step, peak_lr=tcfg.learning_rate,
                                    warmup_steps=tcfg.warmup_steps,
                                    total_steps=total_steps)
        params, opt, gstats = adamw.update(
            grads, ts.opt, ts.params, lr=lr, b1=tcfg.adam_b1,
            b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            weight_decay=tcfg.weight_decay, max_grad_norm=tcfg.max_grad_norm)
        metrics = dict(stats, loss=loss, lr=lr,
                       grad_norm=gstats["grad_norm"])
        return TrainState(params, opt, ts.step + 1), metrics

    return train_step
