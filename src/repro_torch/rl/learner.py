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
V-trace). The data-parallel layout (``axis_name``, ``num_shards``) comes
with the data-parallel slice.

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


def make_ocean_learn(policy, tcfg: TrainConfig, dist, adv_fn=None):
    """The post-rollout half of the update: GAE → minibatched clipped-PPO
    epochs. Returns ``learn(ts, carry0, traj, last_value, generator,
    perms=None) → (ts, metrics)``; ``metrics`` are 0-dim device tensors.
    ``adv_fn(params, traj, last_value) → (adv, returns)`` replaces GAE
    (``make_vtrace_adv``), computed once per update from the pre-update
    params, where GAE runs."""
    E, M = tcfg.update_epochs, tcfg.num_minibatches

    def learn(ts: TrainState, carry0, traj: Trajectory, last_value,
              generator: torch.Generator = None, perms=None):
        T, B = traj.rewards.shape
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
