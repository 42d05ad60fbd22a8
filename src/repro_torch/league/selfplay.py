"""Self-play training — the league's engine integration.

The counterpart of ``repro/league/selfplay.py``. A multi-agent env's agent
rows split into *learner* rows [0, L) acting under the live ``TrainState``
params and *opponent* rows [L, A) acting under frozen params that
``SelfPlay.next_opponent()`` returns once per engine launch (an
``OpponentSampler`` over the ``PolicyStore``). The rollout records only
learner rows — opponent behavior is part of the environment from the
learner's perspective — and feeds the exact same ``make_ocean_learn`` PPO
math as ordinary training, so GAE goes through ``kernels.ops.gae``.

Randomness: the reference folds separate keys for the learner rows, the
opponent rows and the envs, by global row and env index. Here every step
draws from the engine's generator in a fixed order — learner sample,
opponent sample, env step — so K updates in one launch equal K launches
of one update, and a checkpointed self-play run resumes bitwise. With one
generator per env block (the data-parallel layout, ``core/vector.py``)
block s's learner rows, opponent rows and envs draw from generator s in
that order, as rank s of an S-rank run draws them.

On the ``shard_map`` tier rank 0 samples the opponent and the engine
broadcasts it; ``run_selfplay`` keeps the store, the ratings and the
arena on rank 0 and hands the final winrate to every rank.

``run_selfplay`` is the loop behind ``launch.train --selfplay``:
snapshot the learner into the store on a cadence, rate each snapshot
against the pool in the arena, and sample opponents by rating.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import TrainConfig
from repro_torch.rl.learner import make_ocean_learn
from repro_torch.rl.rollout import Trajectory, sample


class SelfPlayCarry(NamedTuple):
    """RolloutCarry with a second policy carry for the frozen opponent rows
    (recurrent opponents replay their snapshot's architecture)."""
    env_state: object
    obs: torch.Tensor           # (N*A, obs) — all rows, agent-major
    policy_carry: object        # learner rows (N*L)
    opp_carry: object           # opponent rows (N*(A-L))
    done_prev: torch.Tensor     # (N*A,)


@dataclasses.dataclass
class SelfPlay:
    """Engine-facing self-play spec: ``next_opponent()`` is called on the
    host once per launch (an ``OpponentSampler.next_params``, or any
    callable returning a param dict on the engine's device);
    ``learner_agents`` is the agent-row split L (0 → num_agents // 2)."""
    next_opponent: Callable[[], object]
    learner_agents: int = 0


@torch.no_grad()
def selfplay_rollout(policy, params, opp_params, step_fn, carry, generator,
                     unroll, dist, num_envs, num_agents, learner_agents):
    """T-step rollout with split agent rows. Returns ``(carry',
    Trajectory-over-learner-rows, last_value (N*L,))``. Each step draws the
    learner rows' actions, then the opponent rows', then the env step's
    (by block when ``generator`` is a list)."""
    N, A, L = num_envs, num_agents, learner_agents
    O = A - L

    def rows(x, lo, hi):
        e = x.reshape((N, A) + tuple(x.shape[1:]))[:, lo:hi]
        return e.reshape((N * (hi - lo),) + tuple(x.shape[1:]))

    steps, c = [], carry
    for _ in range(unroll):
        obs_l, obs_o = rows(c.obs, 0, L), rows(c.obs, L, A)
        reset_l, reset_o = rows(c.done_prev, 0, L), rows(c.done_prev, L, A)
        logits_l, value_l, pc_l = policy.step(params, obs_l, c.policy_carry,
                                              reset=reset_l)
        logits_o, _, pc_o = policy.step(opp_params, obs_o, c.opp_carry,
                                        reset=reset_o)
        act_l = sample(dist, generator, logits_l)
        act_o = sample(dist, generator, logits_o)
        logp_l = dist.log_prob(logits_l, act_l)
        tail = tuple(act_l.shape[1:])
        action = torch.cat([act_l.reshape((N, L) + tail),
                            act_o.reshape((N, O) + tail)],
                           dim=1).reshape((N * A,) + tail)
        env_state, obs, rew, done, info = step_fn(c.env_state, action,
                                                  generator)
        steps.append((obs_l, act_l, logp_l, value_l, rows(rew, 0, L),
                      rows(done, 0, L), reset_l, info))
        c = SelfPlayCarry(env_state, obs, pc_l, pc_o, done)
    cols = list(zip(*steps))
    traj = Trajectory(*(torch.stack(x) for x in cols[:7]),
                      infos={k: torch.stack([i[k] for i in cols[7]])
                             for k in cols[7][0]})
    _, last_value, _ = policy.step(params, rows(c.obs, 0, L), c.policy_carry,
                                   reset=rows(c.done_prev, 0, L))
    return c, traj, last_value


def make_selfplay_update(policy, step_fn, tcfg: TrainConfig, dist,
                         num_envs: int, num_agents: int,
                         learner_agents: int, num_shards: int = 1,
                         group=None):
    """Returns ``update(ts, rc, opp_params, generator) → (ts, rc,
    metrics)`` — the self-play twin of ``learner.make_ocean_update``:
    split-row rollout, then the shared PPO learn over the learner rows only.
    Its halves are ``update.collect(ts, rc, opp_params, generator) → (rc,
    (carry0, traj, last_value))`` and ``update.learn``. ``num_envs`` is
    this rank's; ``num_shards`` and ``group`` are ``make_ocean_learn``'s."""
    learn = make_ocean_learn(policy, tcfg, dist, num_shards=num_shards,
                             group=group)

    def collect(ts, rc: SelfPlayCarry, opp_params, generator):
        carry0 = rc.policy_carry
        rc, traj, last_value = selfplay_rollout(
            policy, ts.params, opp_params, step_fn, rc, generator,
            tcfg.unroll_length, dist, num_envs, num_agents, learner_agents)
        return rc, (carry0, traj, last_value)

    def update(ts, rc: SelfPlayCarry, opp_params, generator):
        rc, batch = collect(ts, rc, opp_params, generator)
        ts, metrics = learn(ts, *batch, generator)
        return ts, rc, metrics

    update.collect, update.learn = collect, learn
    return update


# -- the league loop ----------------------------------------------------------

def build_league(env, tcfg: TrainConfig, *, league_dir: str,
                 hidden: int = 64, recurrent: bool = False,
                 conv: bool = None, strategy: str = "prioritized",
                 seed: int = 0, learner_agents: int = 0,
                 arena_envs: int = 16, backend: str = None, device=None,
                 mesh=None):
    """Wire a complete league around ``env``: (engine, store, ranker,
    sampler, arena). The store is seeded with the engine's init params as
    version 0 if empty (by rank 0), so sampling always has an opponent."""
    from repro_torch.league.arena import Arena
    from repro_torch.league.ranker import OpponentSampler, Ranker
    from repro_torch.league.store import PolicyStore
    from repro_torch.rl.engine import TrainEngine
    from repro_torch.rl.trainer import ocean_policy_stack

    dev = _device.resolve(device)
    em, dist, policy = ocean_policy_stack(env, hidden=hidden,
                                          recurrent=recurrent, conv=conv)
    store = PolicyStore(league_dir)
    ranker = Ranker(store.ratings())
    sampler = OpponentSampler(store, ranker, policy.abstract(dev),
                              strategy=strategy, seed=seed)
    engine = TrainEngine(
        em, policy, tcfg, dist, seed=seed, device=dev, backend=backend,
        mesh=mesh, selfplay=SelfPlay(sampler.next_params, learner_agents))
    if engine.rank == 0 and len(store) == 0:
        store.add(engine.ts.params, step=0)
    arena = Arena(em, policy, dist, num_envs=arena_envs,
                  learner_agents=learner_agents or em.num_agents // 2,
                  device=dev)
    return engine, store, ranker, sampler, arena


class LeagueResult(NamedTuple):
    history: list               # per-update metric dicts (engine history)
    store: object               # the PolicyStore (latest version = final)
    ranker: object              # Ranker with post-run ratings
    winrate_random: float       # final params vs the random baseline


def run_selfplay(env, tcfg: TrainConfig, *, league_dir: str,
                 total_steps: int, snapshot_every: int = 10,
                 rate_matches: int = 4, hidden: int = 64,
                 recurrent: bool = False, conv: bool = None,
                 strategy: str = "prioritized",
                 seed: int = 0, learner_agents: int = 0,
                 backend: str = None, device=None, mesh=None,
                 log_every: int = 0) -> LeagueResult:
    """Self-play training loop: every ``snapshot_every`` updates the learner
    is snapshotted into the store, rated against up to ``rate_matches``
    pool members in one batched arena pass, and the ratings persist to
    ``league_dir/league.json``. The returned ``winrate_random`` is the
    final learner's match outcome vs the random-policy skill floor — the
    league's solved criterion (self-play score hovers near 0.5 by
    construction, so score can't be one)."""
    engine, store, ranker, sampler, arena = build_league(
        env, tcfg, league_dir=league_dir, hidden=hidden, recurrent=recurrent,
        conv=conv, strategy=strategy, seed=seed,
        learner_agents=learner_agents, backend=backend, device=device,
        mesh=mesh)
    dev = engine.device
    lead = engine.rank == 0
    rate_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    last = {"score": None}

    def on_update(u, m):
        last["score"] = m["score"]
        if log_every and (u % log_every == 0):
            print(f"  upd {u:4d} steps {m['env_steps']:7d} "
                  f"score {m['score']:.3f} opp v{sampler.history[-1]} "
                  f"sps {m['sps']:.0f}", flush=True)

    snap = {"through": 0}

    def on_launch(u):
        if not lead or (u // snapshot_every
                        <= snap["through"] // snapshot_every):
            return
        snap["through"] = u
        params = engine.ts.params
        v = store.add(params, step=u * engine.steps_per_update,
                      score=last["score"])
        pool = [x for x in store.versions() if x != v][-rate_matches:]
        if pool:
            stacked = store.load_stacked(pool, sampler.like)
            for opp, res in zip(pool, arena.vs_pool(params, stacked,
                                                    rate_gen)):
                ranker.update(v, opp, res["outcome"])
            store.set_ratings(ranker.ratings)

    try:
        history, _ = engine.run(total_steps, on_update=on_update,
                                on_launch=on_launch)
        final = engine.ts.params
        wr = 0.0
        if lead:
            if snap["through"] != len(history):  # last launch not snapshotted
                store.add(final, step=len(history) * engine.steps_per_update,
                          score=last["score"])
            for v in store.versions():      # unrated versions get the default
                ranker.ratings.setdefault(v, ranker.rating(v))
            store.set_ratings(ranker.ratings)
            wr = arena.play_random(
                final, torch.Generator(device=dev).manual_seed(seed + 2))[
                    "outcome"]
        if engine.group is not None:
            from repro_torch.distributed.sharding import broadcast_tree
            wr = float(broadcast_tree(
                torch.tensor([float(wr)], device=dev), engine.group)[0])
    finally:
        engine.close()
    return LeagueResult(history, store, ranker, wr)
