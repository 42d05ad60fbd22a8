"""The port's Policy League against the JAX package: the store across
packages, Elo, the samplers' version sequences, the arena's batched pool,
the self-play engine tier, one self-play learn from JAX's own split-row
trajectory, a bitwise self-play resume, and the CLIs.

The counterpart of tests/test_league.py, on the CPU (``device="cpu"``).
Randomness has no shared stream, so training is compared by outcome; the
learn is compared at the tolerances of tests/test_torch_ppo.py.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import emulation as jem
from repro.core.vector import VecEnv as JVecEnv
from repro.envs import ocean as jocean
from repro.league import OpponentSampler as JSampler
from repro.league import PolicyStore as JStore
from repro.league import Ranker as JRanker
from repro.league import selfplay as jselfplay
from repro.models import policy as jpolicy
from repro.rl import distributions as jD
from repro.rl import learner as jlearner
from repro_torch.configs.base import TrainConfig
from repro_torch.envs import ocean
from repro_torch.launch import train as train_cli
from repro_torch.league.arena import _index
from repro_torch.league.store import _stack as _stack_trees
from repro_torch.league import (Arena, OpponentSampler, PolicyStore, Ranker,
                                SelfPlay, SelfPlayCarry,
                                make_selfplay_update, run_selfplay)
from repro_torch.models.convert import ocean_params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import learner as tlearner
from repro_torch.rl.engine import METRIC_KEYS, TrainEngine
from repro_torch.rl.rollout import Trajectory
from repro_torch.rl.trainer import ocean_policy_stack

ROOT = Path(__file__).resolve().parent.parent
TCFG = TrainConfig(num_envs=16, unroll_length=16, update_epochs=2,
                   num_minibatches=2, learning_rate=1e-3, gamma=0.95)
THREADS = 2     # these batches are small; more threads only contend


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)


def _policy(env, hidden=32, recurrent=False):
    return ocean_policy_stack(env, hidden=hidden, recurrent=recurrent)


def _init(pol, seed):
    return pol.init(torch.Generator().manual_seed(seed))


def _stack(trees):
    return _stack_trees(trees, torch.stack)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# =========================== PolicyStore =====================================

def test_store_roundtrip_and_metadata(tmp_path):
    _, _, pol = _policy(ocean.Duel())
    store = PolicyStore(str(tmp_path))
    p0, p1 = _init(pol, 0), _init(pol, 1)
    v0 = store.add(p0, step=0, score=0.5)
    v1 = store.add(p1, step=1000, score=0.7, rating=1100.0)
    assert (v0, v1) == (0, 1) and store.versions() == [0, 1]
    assert store.latest() == 1 and len(store) == 2
    assert store.meta(1) == {"step": 1000, "score": 0.7, "rating": 1100.0}
    store.add(p0, step=2000)              # inherits the latest rating
    assert store.meta(2)["rating"] == 1100.0
    assert _equal_trees(store.load(v1, pol.abstract()), p1)
    store2 = PolicyStore(str(tmp_path))   # a second handle, the same league
    assert store2.versions() == [0, 1, 2]
    assert store2.meta(1)["rating"] == 1100.0
    with pytest.raises(FileNotFoundError):
        store2.load(7, pol.abstract())    # no quiet re-initialisation


def test_store_load_stacked(tmp_path):
    _, _, pol = _policy(ocean.Duel())
    store = PolicyStore(str(tmp_path))
    trees = [_init(pol, i) for i in range(3)]
    for t in trees:
        store.add(t)
    stacked = store.load_stacked([0, 1, 2], pol.abstract())
    for name in ("enc1", "act"):
        assert stacked[name].shape == (3,) + tuple(trees[0][name].shape)
        for i in range(3):
            assert torch.equal(stacked[name][i], trees[i][name])


def _jax_params(recurrent, seed=3):
    em = jem.Emulated(jocean.Duel())
    jp = jpolicy.OceanPolicy(em.obs_spec.total, (5,), hidden=16,
                             recurrent=recurrent, num_outputs=5)
    params = jax.tree.map(np.asarray, jp.init(jax.random.PRNGKey(seed)))
    return jp, params, ocean_params_from_jax(params)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("recurrent", [False, True])
def test_store_crosses_packages(tmp_path, writer, recurrent):
    """A store the JAX package wrote reads in the port, and the reverse:
    the versions, their metadata and ratings, and the params."""
    jp, jparams, tparams = _jax_params(recurrent)
    _, jparams2, tparams2 = _jax_params(recurrent, seed=4)
    if writer == "jax":
        s = JStore(str(tmp_path))
        s.add(jparams, step=10, score=0.25)
        s.add(jparams2, step=20, rating=1050.0)
        got = PolicyStore(str(tmp_path))
        like = jax.tree.map(torch.zeros_like, tparams)
        assert _equal_trees(got.load(0, like), tparams)
        stacked = got.load_stacked([0, 1], like)
        assert _equal_trees(_index(stacked, 1), tparams2)
    else:
        s = PolicyStore(str(tmp_path))
        s.add(tparams, step=10, score=0.25)
        s.add(tparams2, step=20, rating=1050.0)
        got = JStore(str(tmp_path))
        r = got.load(1, jp.abstract())
        for x, y in zip(jax.tree.leaves(r), jax.tree.leaves(jparams2)):
            np.testing.assert_array_equal(np.asarray(x), y)
    assert got.versions() == [0, 1]
    assert got.meta(0) == {"step": 10, "score": 0.25, "rating": 1000.0}
    assert got.meta(1) == {"step": 20, "score": None, "rating": 1050.0}


# =============================== Ranker ======================================

def test_ranker_elo_updates_equal_jax():
    rng = np.random.default_rng(0)
    records = [(int(a), int(b), float(o)) for a, b, o in
               zip(rng.integers(0, 6, 300), rng.integers(0, 6, 300),
                   rng.choice([0.0, 0.5, 1.0, 0.25], 300)) if a != b]
    t, j = Ranker({2: 1200.0}, k=24.0), JRanker({2: 1200.0}, k=24.0)
    t.record(records)
    j.record(records)
    assert t.ratings == j.ratings
    assert t.rank() == j.rank() and t.leaderboard() == j.leaderboard()
    assert t.expected(0, 1) == j.expected(0, 1)


def test_ranker_elo_is_zero_sum_and_recovers_planted_skills():
    r = Ranker()
    r.update(0, 1, 1.0)
    assert r.rating(0) > 1000.0 > r.rating(1)
    assert abs(r.rating(0) + r.rating(1) - 2000.0) < 1e-9
    skills = {0: -2.0, 1: -1.0, 2: 0.0, 3: 1.0, 4: 2.0}
    rng = np.random.default_rng(7)
    ranker = Ranker()
    for _ in range(400):
        a, b = rng.choice(5, size=2, replace=False)
        p_a = 1.0 / (1.0 + np.exp(-(skills[a] - skills[b])))
        ranker.update(int(a), int(b), float(rng.random() < p_a))
    assert ranker.rank() == [4, 3, 2, 1, 0], ranker.ratings


# ============================== Samplers =====================================

def _seeded_store(tmp_path, pol, n=5):
    store = PolicyStore(str(tmp_path))
    for i in range(n):
        store.add(_init(pol, i))
    return store


@pytest.mark.parametrize("strategy", ["latest", "uniform", "prioritized"])
def test_sampler_version_sequence_equals_jax(tmp_path, strategy):
    """The same seed, ratings and strategy draw the same versions as the
    JAX sampler over the same store directory."""
    _, _, pol = _policy(ocean.Duel())
    store = _seeded_store(tmp_path, pol)
    ratings = {0: 900.0, 1: 950.0, 2: 1000.0, 3: 1050.0, 4: 1060.0}
    t = OpponentSampler(store, Ranker(ratings), pol.abstract(),
                        strategy=strategy, seed=123)
    j = JSampler(JStore(str(tmp_path)), JRanker(ratings), None,
                 strategy=strategy, seed=123)
    draws = [t.sample() for _ in range(40)]
    assert draws == [j.sample() for _ in range(40)]
    if strategy == "latest":
        assert set(draws) == {4}
    else:
        assert len(set(draws)) > 1


def test_prioritized_sampler_favors_rating_proximity_and_caches(tmp_path):
    _, _, pol = _policy(ocean.Duel())
    store = _seeded_store(tmp_path, pol)
    ranker = Ranker({0: 200.0, 1: 1000.0, 2: 1000.0, 3: 1000.0, 4: 1000.0})
    s = OpponentSampler(store, ranker, pol.abstract(),
                        strategy="prioritized", seed=0, temperature=100.0)
    draws = [s.sample() for _ in range(200)]
    assert draws.count(0) < 0.1 * len(draws)
    s2 = OpponentSampler(store, ranker, pol.abstract(), strategy="latest",
                         seed=0)
    first = s2.next_params()
    assert s2.next_params() is first          # cached: no store I/O
    assert _equal_trees(first, _init(pol, 4))
    with pytest.raises(ValueError, match="strategy"):
        OpponentSampler(store, ranker, pol.abstract(), strategy="best")


def test_sampler_empty_store_raises(tmp_path):
    _, _, pol = _policy(ocean.Duel())
    s = OpponentSampler(PolicyStore(str(tmp_path / "empty")), Ranker(),
                        pol.abstract())
    with pytest.raises(ValueError, match="empty"):
        s.sample()


# ================================ Arena ======================================

def _arena(num_envs=4, steps=40, recurrent=False):
    em, dist, pol = _policy(ocean.Duel(), recurrent=recurrent)
    return Arena(em, pol, dist, num_envs=num_envs, steps=steps,
                 device="cpu"), pol


@pytest.mark.parametrize("recurrent", [False, True])
def test_arena_pool_equals_sequential(recurrent):
    """The batched K-opponent pass gives exactly the per-opponent results
    of K forward passes a step, from the same generator state."""
    arena, pol = _arena(num_envs=8, steps=70, recurrent=recurrent)
    pa = _init(pol, 0)
    stacked = _stack([_init(pol, i) for i in range(1, 5)])
    pooled = arena.vs_pool(pa, stacked, torch.Generator().manual_seed(42))
    seq = arena.vs_pool_sequential(pa, stacked,
                                   torch.Generator().manual_seed(42))
    assert len(pooled) == len(seq) == 4
    assert pooled == seq
    assert len({r["outcome"] for r in pooled}) > 1     # opponents differ
    # opponent i of the pool plays as it does on its own rows of the batch
    r = arena._match(("one", pa), ("one", _init(pol, 3)), 4,
                     torch.Generator().manual_seed(42))
    assert r[2] == pooled[2]


def test_arena_round_robin_records():
    arena, pol = _arena()
    stacked = _stack([_init(pol, i) for i in range(3)])
    recs = arena.round_robin(stacked, [10, 11, 12],
                             torch.Generator().manual_seed(0))
    assert [(a, b) for a, b, _ in recs] == [(10, 11), (10, 12), (11, 12)]
    assert all(0.0 <= o <= 1.0 for _, _, o in recs)
    ranker = Ranker()
    ranker.record(recs)
    assert set(ranker.ratings) == {10, 11, 12}


def test_arena_outcomes_are_mirror_consistent():
    arena, pol = _arena(num_envs=8, steps=66)
    pa, pb = _init(pol, 0), _init(pol, 1)
    r = arena.play(pa, pb, torch.Generator().manual_seed(5))
    assert r["episodes"] == r["wins_a"] + r["wins_b"] + r["draws"]
    assert r["episodes"] >= 8            # 66 steps of horizon-32 episodes
    assert 0.0 <= r["outcome"] <= 1.0
    rr = arena.play_random(pa, torch.Generator().manual_seed(5))
    assert rr["episodes"] >= 8 and 0.0 <= rr["outcome"] <= 1.0


def test_arena_rejects_single_agent_env():
    em, dist, pol = _policy(ocean.Bandit())
    with pytest.raises(ValueError, match="multi-agent"):
        Arena(em, dist=dist, policy=pol, device="cpu")


# ========================= self-play engine tier =============================

def _selfplay_engine(env, recurrent=False, learner_agents=0, tcfg=TCFG, K=1,
                     opp_seed=99, seed=0):
    em, dist, pol = _policy(env, recurrent=recurrent)
    opp = _init(pol, opp_seed)
    return TrainEngine(em, pol, tcfg, dist, seed=seed, device="cpu",
                       updates_per_launch=K,
                       selfplay=SelfPlay(lambda: opp, learner_agents))


@pytest.mark.parametrize("name,recurrent",
                         [("duel", False), ("multiagent", False),
                          ("tagteam", False), ("duel", True)])
def test_selfplay_smoke(name, recurrent):
    """Self-play splits rows and trains on the competitive env AND on the
    ordinary multi-agent envs (Multiagent A=2, TagTeam A=6 with padding)."""
    e = _selfplay_engine(ocean.OCEAN[name](), recurrent=recurrent)
    assert isinstance(e.rc, SelfPlayCarry)
    hist, _ = e.run(2 * e.steps_per_update)
    assert len(hist) == 2
    assert np.isfinite(hist[-1]["loss"]) and np.isfinite(hist[-1]["entropy"])
    A = e.vec.num_agents
    if recurrent:
        assert e.rc.policy_carry[0].shape == (TCFG.num_envs * (A // 2), 32)
        assert e.rc.opp_carry[0].shape == (TCFG.num_envs * (A - A // 2), 32)


def test_selfplay_opponent_resampled_each_launch():
    em, dist, pol = _policy(ocean.Duel())
    calls = {"n": 0}

    def next_opponent():
        calls["n"] += 1
        return _init(pol, calls["n"])

    e = TrainEngine(em, pol, TCFG, dist, seed=0, device="cpu",
                    updates_per_launch=2, selfplay=SelfPlay(next_opponent))
    e.run(6 * e.steps_per_update)        # 3 launches of K=2
    assert calls["n"] == 3


@pytest.mark.parametrize("recurrent", [False, True])
def test_selfplay_fused_launch_equals_sequential_launches(recurrent):
    fused = _selfplay_engine(ocean.Duel(), recurrent=recurrent, K=2)
    seq = _selfplay_engine(ocean.Duel(), recurrent=recurrent)
    ring = fused.launch(2)
    rows = torch.cat([seq.launch(1) for _ in range(2)])
    assert torch.equal(ring, rows)
    assert _equal_trees(fused.ts.params, seq.ts.params)
    assert torch.equal(fused.generator.get_state(), seq.generator.get_state())


def test_selfplay_learner_actually_learns_vs_frozen():
    """Against a FROZEN opponent the learner's score climbs well past the
    0.5 symmetry point — opponent rows are part of the env, not of the PPO
    batch."""
    tcfg = TrainConfig(num_envs=32, unroll_length=32, update_epochs=2,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    e = _selfplay_engine(ocean.Duel(), tcfg=tcfg)
    hist, _ = e.run(40 * e.steps_per_update)
    late = [m["score"] for m in hist[-5:] if m["episodes"] > 0]
    assert np.mean(late) > 0.7, late


def test_selfplay_rejects_bad_configs():
    em, dist, pol = _policy(ocean.Bandit())
    opp = _init(pol, 1)
    with pytest.raises(ValueError, match="multi-agent"):
        TrainEngine(em, pol, TCFG, dist, device="cpu",
                    selfplay=SelfPlay(lambda: opp))
    em2, dist2, pol2 = _policy(ocean.Duel())
    with pytest.raises(ValueError, match="learner_agents"):
        TrainEngine(em2, pol2, TCFG, dist2, device="cpu",
                    selfplay=SelfPlay(lambda: opp, learner_agents=2))
    for backend in ("pool", "async"):
        with pytest.raises(ValueError, match="tiers"):
            TrainEngine(em2, pol2, TCFG, dist2, device="cpu",
                        backend=backend, selfplay=SelfPlay(lambda: opp))


@pytest.mark.parametrize("name,recurrent", [("duel", False),
                                            ("tagteam", False),
                                            ("duel", True)])
def test_selfplay_learn_matches_jax_from_its_split_row_trajectory(
        name, recurrent):
    """JAX's split-row self-play rollout, then JAX's ``make_ocean_learn``
    over its learner rows; the port's ``make_selfplay_update`` learn on the
    same trajectory, carry and permutations gives the same params, AdamW
    moments and metrics."""
    cfg = dict(num_envs=8, unroll_length=16, update_epochs=2,
               num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    jt, tt = JTrainConfig(**cfg), TrainConfig(**cfg)
    env = jocean.OCEAN[name]()
    em = jem.Emulated(env)
    dist = jD.Dist("categorical", nvec=em.act_spec.nvec)
    pol = jpolicy.OceanPolicy(em.obs_spec.total, dist.nvec, hidden=32,
                              recurrent=recurrent,
                              num_outputs=dist.num_outputs)
    N, A = cfg["num_envs"], em.num_agents
    L = A // 2
    key = jax.random.PRNGKey(0)
    params = pol.init(jax.random.fold_in(key, 0))
    opp = pol.init(jax.random.fold_in(key, 9))
    vec = JVecEnv(em, N)
    state, obs = vec.init(jax.random.fold_in(key, 1))
    rc = jselfplay.SelfPlayCarry(state, obs, pol.initial_carry(N * L),
                                 pol.initial_carry(N * (A - L)),
                                 jnp.zeros((N * A,), jnp.bool_))
    step_fn = vec.step_keyed_fn()
    args = (16, dist, N, jnp.zeros((), jnp.int32), A, L)
    rc, _, _ = jselfplay.selfplay_rollout(pol, params, opp, step_fn, rc,
                                          jax.random.fold_in(key, 2), *args)
    carry0 = rc.policy_carry
    rc, traj, last_value = jselfplay.selfplay_rollout(
        pol, params, opp, step_fn, rc, jax.random.fold_in(key, 3), *args)
    assert traj.rewards.shape == (16, N * L)
    assert bool(jnp.any(traj.dones)), "no episode ends in the data"
    kperm = jax.random.fold_in(key, 4)
    learn = jax.jit(jlearner.make_ocean_learn(pol, jt, dist,
                                              kernel_mode="ref"))
    jts, jm = learn(jlearner.init_train_state(params), carry0, traj,
                    last_value, kperm)
    E, M = jt.update_epochs, jt.num_minibatches
    n = N * L if recurrent else 16 * N * L
    perms = jnp.concatenate([
        jax.random.permutation(jax.random.fold_in(kperm, e), n)
        .reshape(M, n // M) for e in range(E)])

    tem_env, tdist, tpol = _policy(ocean.OCEAN[name](), recurrent=recurrent)
    T = lambda x: torch.from_numpy(np.array(x))
    ttraj = Trajectory(*(T(x) for x in traj[:7]),
                       infos={k: T(v) for k, v in traj.infos.items()})
    tcarry0 = tuple(map(T, carry0)) if carry0 is not None else None
    update = make_selfplay_update(tpol, None, tt, tdist, N, A, L)
    ts0 = tlearner.init_train_state(
        ocean_params_from_jax(jax.tree.map(np.asarray, params)))
    ts1, tm = update.learn(ts0, tcarry0, ttraj, T(last_value),
                           perms=T(perms).long())
    tol = dict(atol=1e-5, rtol=1e-4)
    for got, want in ((ts1.params, jts.params), (ts1.opt.m, jts.opt.m)):
        for k in want:
            w = want[k]
            if isinstance(w, dict):
                for kk in w:
                    np.testing.assert_allclose(got[k][kk].numpy(),
                                               np.asarray(w[kk]), **tol)
            else:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                           **tol)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("recurrent", [False, True])
def test_selfplay_checkpoint_resumes_bitwise(tmp_path, recurrent):
    """The self-play carry (the opponent rows' carry beside the learner's)
    saves and restores like any rollout carry: stopped after 3 updates,
    restored into a new engine and run on, it ends bitwise equal to an
    uninterrupted run."""
    a = _selfplay_engine(ocean.Duel(), recurrent=recurrent)
    a.run(5 * a.steps_per_update)
    b = _selfplay_engine(ocean.Duel(), recurrent=recurrent)
    b.checkpoint_dir = str(tmp_path)
    b.run(3 * b.steps_per_update)
    b.save_checkpoint(3)
    c = _selfplay_engine(ocean.Duel(), recurrent=recurrent, seed=7)
    c.checkpoint_dir = str(tmp_path)
    assert c.restore() == 3
    hist, _ = c.run(5 * c.steps_per_update)
    assert len(hist) == 2
    assert torch.equal(a.generator.get_state(), c.generator.get_state())
    assert _equal_trees(a.ts.params, c.ts.params)
    assert _equal_trees({"m": a.ts.opt.m, "v": a.ts.opt.v},
                        {"m": c.ts.opt.m, "v": c.ts.opt.v})
    la = [x for x in jax.tree.leaves(a.rc, is_leaf=torch.is_tensor)]
    lc = [x for x in jax.tree.leaves(c.rc, is_leaf=torch.is_tensor)]
    assert len(la) == len(lc) and all(torch.equal(x, y)
                                      for x, y in zip(la, lc))


# ========================== the run_selfplay loop ============================

def test_run_selfplay_builds_league(tmp_path):
    """Versions accumulate (init + snapshots + final), ratings persist to
    league.json, and a second run on the same directory picks them up."""
    tcfg = TrainConfig(num_envs=8, unroll_length=16, update_epochs=1,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    res = run_selfplay(ocean.Duel(), tcfg, league_dir=str(tmp_path),
                       total_steps=6 * 16 * 8 * 2, snapshot_every=2,
                       hidden=16, seed=0, device="cpu")
    assert len(res.history) == 6
    assert len(res.store) >= 3           # v0 + >=1 snapshot + final
    with open(tmp_path / "league.json") as f:
        idx = json.load(f)
    assert set(idx["versions"]) == {str(v) for v in res.store.versions()}
    assert all(v in res.ranker.ratings for v in res.store.versions())
    assert 0.0 <= res.winrate_random <= 1.0
    res2 = run_selfplay(ocean.Duel(), tcfg, league_dir=str(tmp_path),
                        total_steps=16 * 8 * 2, snapshot_every=2,
                        hidden=16, seed=1, device="cpu")
    assert len(res2.store) == len(res.store) + 1


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(THREADS))
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_selfplay_cli_and_league_ls(tmp_path):
    d = str(tmp_path / "league")
    r = _cli("repro_torch.launch.train", "--ocean", "duel", "--selfplay",
             "--league-dir", d, "--device", "cpu", "--num-envs", "8",
             "--total-env-steps", "4096", "--snapshot-every", "2")
    assert r.returncode == 0, r.stderr
    assert "winrate_vs_random=" in r.stdout and "versions=[0, 1, 2]" in \
        r.stdout and "updates=4" in r.stdout
    r = _cli("repro_torch.league", "ls", "--league-dir", d)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].split() == ["rank", "version", "rating", "step", "score"]
    assert len(lines) == 4
    r = _cli("repro_torch.league", "arena", "--league-dir", d, "--device",
             "cpu", "--num-envs", "4")
    assert r.returncode == 0, r.stderr
    assert "played 3 matches over versions 0..2" in r.stdout


@pytest.mark.parametrize("argv,msg", [
    (["--ocean", "duel", "--selfplay"], "--league-dir"),
    (["--selfplay", "--league-dir", "x"], "--ocean"),
    (["--ocean", "duel", "--selfplay", "--league-dir", "x",
      "--engine-backend", "async"], "async tier"),
    (["--ocean", "duel", "--selfplay", "--league-dir", "x",
      "--engine-backend", "pool"], "jit tier")])
def test_selfplay_cli_rejects_bad_flags(argv, msg, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--device", "cpu"])
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("recurrent,conv", [(False, False), (True, False),
                                            (False, True)])
def test_step_stacked_equals_one_step_per_param_set(recurrent, conv):
    """K stacked param sets through one batched pass give each set's own
    ``step`` over its rows: logits, values and carries."""
    from repro_torch.models.policy import OceanPolicy
    pol = OceanPolicy(36, (5,), hidden=16, recurrent=recurrent,
                      conv_shape=(6, 6) if conv else None)
    K, R = 3, 10
    sets = [_init(pol, i) for i in range(K)]
    g = torch.Generator().manual_seed(0)
    obs = torch.rand((K, R, 36), generator=g)
    reset = torch.rand((K, R), generator=g) < 0.3
    carry = ((torch.randn((K, R, 16), generator=g),
              torch.randn((K, R, 16), generator=g)) if recurrent else None)
    lg, v, c = pol.step_stacked(_stack(sets), obs, carry, reset)
    for i in range(K):
        li, vi, ci = pol.step(sets[i], obs[i],
                              None if carry is None
                              else (carry[0][i], carry[1][i]), reset[i])
        torch.testing.assert_close(lg[i], li, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(v[i], vi, rtol=1e-6, atol=1e-6)
        if recurrent:
            torch.testing.assert_close(c[1][i], ci[1], rtol=1e-6, atol=1e-6)
