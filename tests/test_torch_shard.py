"""The data-parallel tier against the JAX package and against itself.

* ``normalize_adv`` over a process group against the reference's ``pmean``
  form (``jax.vmap`` with an axis name over the same shards);
* the port's ``make_ocean_learn(num_shards=4)`` (flat and recurrent) and the
  self-play learn against ``repro.rl.learner.make_ocean_learn(num_shards=4)``
  from one trajectory made with numpy from a seed, the same params
  (``params_from_jax``) and the same permutations, built here with the
  reference's own ``fold_in`` / ``permutation`` / ``to_global`` and passed
  as ``perms``: params, AdamW moments, loss and stats within atol 1e-5
  (rtol 1e-4, as the one-device learn test: E·M AdamW steps sum gradients
  in another order);
* the ``shard_map`` tier at world size 1 (gloo, in this process) bit for
  bit against the jit tier, on squared and on duel self-play;
* two ranks spawned over gloo (``RANKS``, one subprocess): the tier at world
  size 2 against the jit tier's ``num_shards=2`` emulation over 3 updates
  at K = 2 on bandit and 2 on duel self-play (params within 1e-5), a run
  saved at update 2 and resumed bit for bit equal to an uninterrupted one,
  and a rank that dies making the survivor's collective raise;
* the per-block env draws: a ``VecEnv`` stepped with S generators equals S
  ``VecEnv``s of one block each, for all 13 envs;
* the tier's errors (``tests/test_engine.py``'s, and the shard_map ones),
  the mesh module and the launcher's ``--devices 2 --device cpu``.
"""
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
from repro.envs import ocean as jocean
from repro.models import policy as jpolicy
from repro.rl import distributions as jD
from repro.rl import learner as jlearner
from repro.rl import ppo as jppo
from repro.rl import rollout as jrollout
from repro_torch.configs.base import TrainConfig
from repro_torch.core.vector import VecEnv, block_generators, block_seed
from repro_torch.distributed import sharding as shd
from repro_torch.envs import ocean
from repro_torch.launch import mesh as tmesh
from repro_torch.league.selfplay import SelfPlay, make_selfplay_update
from repro_torch.models import policy as tpolicy
from repro_torch.models.convert import ocean_params_from_jax
from repro_torch.optim import adamw
from repro_torch.rl import distributions as tD
from repro_torch.rl import learner as tlearner
from repro_torch.rl import ppo as tppo
from repro_torch.rl.engine import METRIC_KEYS, TrainEngine
from repro_torch.rl.rollout import Trajectory
from repro_torch.rl.trainer import Trainer, ocean_policy_stack

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-4)
torch.set_num_threads(2)


def _close_tree(got, want, **tol):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


def _equal_tree(a, b):
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# -- normalize_adv over a group ---------------------------------------------------

@pytest.fixture
def group1():
    """A gloo group of one rank in this process (the tier makes its own
    this way), destroyed afterwards."""
    own = tmesh.init_process_group(torch.device("cpu"))
    yield torch.distributed.group.WORLD
    if own:
        torch.distributed.destroy_process_group()


def test_normalize_adv_group_of_one_is_the_plain_one_bit_for_bit(group1):
    rng = np.random.default_rng(0)
    for n in (2, 7, 64, 1000):
        adv = torch.from_numpy((3 * rng.standard_normal(n) + 1)
                               .astype(np.float32))
        assert torch.equal(tppo.normalize_adv(adv, True, group1),
                           tppo.normalize_adv(adv, True))
        assert tppo.normalize_adv(adv, False, group1) is adv


def _jax_pmean_normalize(shards):
    """The reference's pmean form over S shards (vmap with an axis name)."""
    return np.asarray(jax.vmap(
        lambda a: jppo.normalize_adv(a, True, axis_name="d"),
        axis_name="d")(jnp.asarray(shards)))


# -- the S-block learn vs the reference's ---------------------------------------------

S4 = 4
CFG = dict(num_envs=16, unroll_length=16, update_epochs=2, num_minibatches=2,
           learning_rate=1e-3, gamma=0.95)


def _block_perms(kperm, E, M, S, n_loc, to_global):
    """The reference's S-block permutations (``learner.py``'s epoch_perm
    with ``axis_name=None`` and S > 1)."""
    out = []
    for e in range(E):
        ke = jax.random.fold_in(kperm, e)
        blocks = [to_global(jax.random.permutation(jax.random.fold_in(ke, s),
                                                   n_loc), s)
                  .reshape(M, n_loc // M) for s in range(S)]
        out.append(jnp.concatenate(blocks, axis=1))
    return np.asarray(jnp.concatenate(out))


def _port_policy(em, dist, recurrent):
    tpol = tpolicy.OceanPolicy(em.obs_spec.total, dist.nvec, hidden=32,
                               recurrent=recurrent,
                               num_outputs=dist.num_outputs)
    tdist = tD.Dist("categorical", nvec=dist.nvec)
    return tpol, tdist


def _case(env, recurrent, B, T=16):
    """The policy, its params and one trajectory of B rows × T steps made
    with numpy from a seed: the reference's learn reads only these arrays
    (the logprobs are the policy's own, taken through the port's policy,
    so ratios start at 1)."""
    em = jem.Emulated(env)
    dist = jD.Dist("categorical", nvec=em.act_spec.nvec)
    pol = jpolicy.OceanPolicy(em.obs_spec.total, dist.nvec, hidden=32,
                              recurrent=recurrent,
                              num_outputs=dist.num_outputs)
    params = jax.jit(pol.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    obs = f32(T, B, em.obs_spec.total)
    actions = np.stack([rng.integers(0, n, (T, B)) for n in dist.nvec],
                       -1).astype(np.int32)
    dones = rng.random((T, B)) < 0.15
    resets = np.concatenate([np.zeros((1, B), bool), dones[:-1]])
    carry0 = (f32(B, 32), f32(B, 32)) if recurrent else None
    tpol, tdist = _port_policy(em, dist, recurrent)
    with torch.no_grad():
        logits, _, _ = tpol.seq(
            ocean_params_from_jax(jax.tree.map(np.asarray, params)),
            torch.from_numpy(obs),
            None if carry0 is None else tuple(map(torch.from_numpy, carry0)),
            torch.from_numpy(resets))
        logp = tdist.log_prob(logits, torch.from_numpy(actions)).numpy()
    infos = {"valid": dones, "score": rng.random((T, B)).astype(np.float32)
             * dones, "episode_return": f32(T, B) * dones}
    traj = jrollout.Trajectory(obs, actions, logp, f32(T, B), f32(T, B),
                               dones, resets, infos)
    return em, dist, pol, params, carry0, traj, f32(B)


def _to_torch(traj, carry0, last_value):
    T = lambda x: torch.from_numpy(np.array(x))
    ttraj = Trajectory(*(T(x) for x in traj[:7]),
                       infos={k: T(v) for k, v in traj.infos.items()})
    tcarry0 = tuple(map(T, carry0)) if carry0 is not None else None
    return ttraj, tcarry0, T(last_value)


def _check_learn(ts1, tm, jts, jm):
    _close_tree(ts1.params, jts.params)
    _close_tree(ts1.opt.m, jts.opt.m)
    _close_tree(ts1.opt.v, jts.opt.v)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)


def _flat_to_global(B, nb):
    return lambda p, s: (p // nb) * B + s * nb + p % nb


@pytest.mark.parametrize("recurrent", [False, True])
def test_learn_num_shards_4_matches_jax(recurrent):
    jt, tt = JTrainConfig(**CFG), TrainConfig(**CFG)
    B, T = CFG["num_envs"], 16
    env = jocean.Memory() if recurrent else jocean.Squared()
    em, dist, pol, params, carry0, traj, last_value = _case(env, recurrent, B)
    kperm = jax.random.PRNGKey(4)
    jts, jm = jax.jit(jlearner.make_ocean_learn(
        pol, jt, dist, kernel_mode="ref", num_shards=S4))(
        jlearner.init_train_state(params), carry0, traj, last_value, kperm)
    nb = B // S4
    if recurrent:
        n_loc, to_global = nb, (lambda p, s: s * nb + p)
    else:
        n_loc, to_global = T * nb, _flat_to_global(B, nb)
    perms = _block_perms(kperm, jt.update_epochs, jt.num_minibatches, S4,
                         n_loc, to_global)
    tpol, tdist = _port_policy(em, dist, recurrent)
    ttraj, tcarry0, tlast = _to_torch(traj, carry0, last_value)
    learn = tlearner.make_ocean_learn(tpol, tt, tdist, num_shards=S4)
    ts0 = tlearner.init_train_state(
        ocean_params_from_jax(jax.tree.map(np.asarray, params)))
    ts1, tm = learn(ts0, tcarry0, ttraj, tlast,
                    perms=torch.from_numpy(perms.copy()).long())
    _check_learn(ts1, tm, jts, jm)
    # with the blocks' own generators: each draws its E permutations of
    # its n_loc indices, mapped into the global minibatches
    seen = []
    orig = tlearner.epoch_perms
    try:
        tlearner.epoch_perms = lambda g, n, E, M: seen.append(n) or orig(
            g, n, E, M)
        _, tm2 = learn(ts0, tcarry0, ttraj, tlast,
                       block_generators(0, S4, "cpu"))
    finally:
        tlearner.epoch_perms = orig
    assert seen == [n_loc] * S4 and np.isfinite(float(tm2["loss"]))


def test_selfplay_learn_num_shards_4_matches_jax():
    """The self-play update's learn (over the learner rows N·L of duel)
    against the reference's S-block learn."""
    jt, tt = JTrainConfig(**CFG), TrainConfig(**CFG)
    N, T = CFG["num_envs"], 16
    env = jocean.Duel()
    A = env.num_agents
    L = A // 2
    B = N * L
    em, dist, pol, params, _, traj, last_value = _case(env, False, B)
    kperm = jax.random.PRNGKey(5)
    jts, jm = jax.jit(jlearner.make_ocean_learn(
        pol, jt, dist, kernel_mode="ref", num_shards=S4))(
        jlearner.init_train_state(params), None, traj, last_value, kperm)
    nb = B // S4
    perms = _block_perms(kperm, jt.update_epochs, jt.num_minibatches, S4,
                         T * nb, _flat_to_global(B, nb))
    tpol, tdist = _port_policy(em, dist, False)
    ttraj, _, tlast = _to_torch(traj, None, last_value)
    update = make_selfplay_update(tpol, None, tt, tdist, N, A, L,
                                  num_shards=S4)
    ts0 = tlearner.init_train_state(
        ocean_params_from_jax(jax.tree.map(np.asarray, params)))
    ts1, tm = update.learn(ts0, None, ttraj, tlast,
                           perms=torch.from_numpy(perms.copy()).long())
    _check_learn(ts1, tm, jts, jm)


def test_learner_names_the_shard_count():
    tt = TrainConfig(**dict(CFG, num_envs=12))
    em, dist, pol = ocean_policy_stack(ocean.Memory(), hidden=8,
                                       recurrent=True)
    learn = tlearner.make_ocean_learn(pol, tt, dist, num_shards=4)
    traj = Trajectory(*(torch.zeros(16, 12) for _ in range(7)), infos={})
    with pytest.raises(ValueError, match=r"envs per data shard \(4 shards\)"):
        learn(None, None, traj, torch.zeros(12), block_generators(0, 4,
                                                                   "cpu"))


# -- per-block env draws --------------------------------------------------------------

@pytest.mark.parametrize("name", list(ocean.OCEAN))
def test_vecenv_blocks_draw_what_each_block_alone_draws(name):
    """A VecEnv of 4 envs stepped with 2 generators equals two VecEnvs of 2
    envs, each with its own generator: init, then 6 random steps."""
    em, dist, _ = ocean_policy_stack(ocean.OCEAN[name](), hidden=8)
    S, N = 2, 4
    whole, part = VecEnv(em, N), VecEnv(em, N // S)
    gw = block_generators(5, S, "cpu")
    gp = block_generators(5, S, "cpu")
    st, _ = whole.init(gw)
    parts = [part.init(g) for g in gp]
    act = torch.Generator().manual_seed(1)

    def same(a, bs):
        if isinstance(a, dict):
            return all(same(a[k], [b[k] for b in bs]) for k in a)
        return torch.equal(a, torch.cat(bs))

    assert same(st, [p[0] for p in parts])
    for _ in range(6):
        logits = torch.randn(whole.batch_size, dist.num_outputs,
                             generator=act)
        a = dist.sample(act, logits)
        out = whole.step(st, a, gw)
        outs = [part.step(parts[s][0], a.chunk(S)[s], gp[s])
                for s in range(S)]
        for i in range(5):              # state, obs, reward, done, info
            assert same(out[i], [o[i] for o in outs]), i
        st = out[0]
        parts = [(o[0], o[1]) for o in outs]


def test_block_seed_rule():
    assert block_seed(7, 0) == 7
    assert block_seed(7, 1) == (7 + 0x9E3779B97F4A7C15) % (1 << 63)
    assert len({block_seed(0, s) for s in range(64)}) == 64


# -- the tier at world size 1, in this process ------------------------------------------

def _tcfg(**kw):
    return TrainConfig(**dict(dict(num_envs=8, unroll_length=16,
                                   update_epochs=2, num_minibatches=2,
                                   learning_rate=1e-3, gamma=0.95), **kw))


def _engine(env, backend="jit", K=1, selfplay=False, **kw):
    em, dist, pol = ocean_policy_stack(env, hidden=32)
    sp = None
    if selfplay:
        opp = pol.init(torch.Generator().manual_seed(99))
        sp = SelfPlay(lambda: opp)
    return TrainEngine(em, pol, _tcfg(), dist, seed=3, device="cpu",
                       backend=backend, updates_per_launch=K, selfplay=sp,
                       **kw)


@pytest.mark.parametrize("env,selfplay", [(ocean.Squared, False),
                                          (ocean.Duel, True)])
def test_shard_map_world_size_1_is_the_jit_tier_bit_for_bit(env, selfplay):
    a = _engine(env(), "jit", K=2, selfplay=selfplay)
    b = _engine(env(), "shard_map", K=2, selfplay=selfplay)
    try:
        assert b.num_shards == 1 and b.mesh.shape == {"data": 1}
        ha, _ = a.run(3 * a.steps_per_update)
        hb, _ = b.run(3 * b.steps_per_update)
        assert _equal_tree(a.ts.params, b.ts.params)
        assert _equal_tree(a.ts.opt.m, b.ts.opt.m)
        assert _equal_tree(a.ts.opt.v, b.ts.opt.v)
        for x, y in zip(ha, hb):
            assert all(x[k] == y[k] for k in METRIC_KEYS)
        st = b.stats()
        # E·M gradient all-reduces a update, and one for the episode sums
        assert st["world_size"] == 1 and st["all_reduces"] == 3 * (2 * 2 + 1)
    finally:
        b.close()
    assert not torch.distributed.is_initialized()


def test_trainer_runs_the_shard_map_tier(tmp_path):
    tr = Trainer(ocean.Squared(), _tcfg(engine_backend="shard_map",
                                        updates_per_launch=2), hidden=32,
                 device="cpu")
    try:
        m = tr.train(4 * tr.steps_per_update,
                     checkpoint_dir=str(tmp_path / "ck"))
        assert len(tr.history) == 4 and np.isfinite(m["loss"])
        assert tr.engine.stats()["backend"] == "shard_map"
    finally:
        tr.engine.close()


def test_engine_config_validation():
    """``tests/test_engine.py``'s checks, and the shard_map tier's."""
    with pytest.raises(ValueError, match="num_shards"):
        _engine(ocean.Bandit(), num_shards=3)       # 8 envs % 3 != 0
    with pytest.raises(ValueError, match="pool tier"):
        _engine(ocean.Bandit(), backend="pool", K=4)
    with pytest.raises(ValueError, match="backend"):
        _engine(ocean.Bandit(), backend="nope")
    with pytest.raises(ValueError, match="derived from the mesh"):
        _engine(ocean.Bandit(), backend="shard_map", num_shards=2)
    with pytest.raises(ValueError, match="no data axes"):
        _engine(ocean.Bandit(), backend="shard_map",
                mesh=tmesh.Mesh(("model",), (1,)))
    with pytest.raises(ValueError, match="not divisible by the mesh"):
        _engine(ocean.Bandit(), backend="shard_map",
                mesh=tmesh.Mesh(("data",), (3,)))
    with pytest.raises(ValueError, match="LM-sharding"):
        _engine(ocean.Bandit(), backend="shard_map",
                mesh=tmesh.Mesh(("data", "model"), (1, 2)))
    with pytest.raises(ValueError, match="only meaningful"):
        _engine(ocean.Bandit(), mesh=tmesh.Mesh(("data",), (1,)))
    assert not torch.distributed.is_initialized()


def test_mesh_module():
    assert tmesh.make_mesh((1,), ("data",)).shape == {"data": 1}
    assert shd.dp_size(tmesh.Mesh(("pod", "data", "model"), (2, 4, 1))) == 8
    assert shd.data_axes(tmesh.Mesh(("data", "model"), (1, 1))) == ("data",)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    cfg = tmesh.mesh_config(multi_pod=True)
    assert (cfg.shape, cfg.dp, cfg.tp) == ((2, 16, 16), 32, 16)


# -- two ranks over gloo ---------------------------------------------------------------

RANKS = r'''
import datetime, multiprocessing as mp, os, socket, sys, time

def worker(rank, port, out):
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    sys.path.insert(0, out)
    import case
    res = {"norm": case.normalize_shard(rank)}
    for name, kw in case.RUNS.items():
        e = case.engine("shard_map", **kw)
        e.run(kw["updates"] * e.steps_per_update)
        res[name] = (e.ts.params, e.ts.opt.m)
    # stop at update 2, save, resume in a new engine, run to 4
    ck = os.path.join(out, "ck")
    a = case.engine("shard_map", updates=4, checkpoint_dir=ck)
    a.run(2 * a.steps_per_update)
    b = case.engine("shard_map", updates=4, checkpoint_dir=ck)
    res["resumed_at"] = b.restore()
    b.run(4 * b.steps_per_update)
    full = case.engine("shard_map", updates=4)
    full.run(4 * full.steps_per_update)
    res["resume"] = (b.ts.params, full.ts.params, b.ts.opt.v, full.ts.opt.v,
                     b.rc.obs, full.rc.obs)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    if rank == 1:
        os._exit(0)                  # rank 1 dies; rank 0's next collective
    time.sleep(1.0)
    t0 = time.perf_counter()
    try:
        dist.all_reduce(torch.ones(1))
        raised = None
    except Exception as e:
        raised = type(e).__name__
    torch.save({"raised": raised, "s": time.perf_counter() - t0},
               os.path.join(out, "dead.pt"))
    os._exit(0)

if __name__ == "__main__":
    s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker, args=(r, port, sys.argv[1]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=200)
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(max(abs(p.exitcode or 0) for p in procs)
             if all(p.exitcode is not None for p in procs) else 1)
'''

CASE = r'''
import torch
from repro_torch.configs.base import TrainConfig
from repro_torch.envs import ocean
from repro_torch.league.selfplay import SelfPlay
from repro_torch.rl import ppo
from repro_torch.rl.engine import TrainEngine
from repro_torch.rl.trainer import ocean_policy_stack

RUNS = {"bandit": dict(env="Bandit", K=2, updates=3),
        "duel": dict(env="Duel", K=1, updates=2, selfplay=True)}

def normalize_shard(rank):
    g = torch.Generator().manual_seed(11)
    adv = 2 * torch.randn(2, 40, generator=g) + 0.5
    return ppo.normalize_adv(adv[rank], True,
                             torch.distributed.group.WORLD)

def engine(backend, env="Bandit", K=2, updates=3, selfplay=False,
           num_shards=1, checkpoint_dir=None):
    tcfg = TrainConfig(num_envs=8, unroll_length=16, update_epochs=2,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95,
                       checkpoint_every=2)
    em, dist, pol = ocean_policy_stack(getattr(ocean, env)(), hidden=32)
    sp = None
    if selfplay:
        opp = pol.init(torch.Generator().manual_seed(99))
        sp = SelfPlay(lambda: opp)
    return TrainEngine(em, pol, tcfg, dist, seed=3, device="cpu",
                       backend=backend, updates_per_launch=K, selfplay=sp,
                       num_shards=num_shards, checkpoint_dir=checkpoint_dir)
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    (d / "ranks.py").write_text(RANKS)
    (d / "case.py").write_text(CASE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(d / "ranks.py"), str(d)],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    sys.path.insert(0, str(d))
    try:
        import case
    finally:
        sys.path.remove(str(d))
    return d, case, [torch.load(d / f"rank{i}.pt", weights_only=False)
                     for i in range(2)]


def test_two_ranks_normalize_adv_matches_pmean(two_ranks):
    _, _, res = two_ranks
    g = torch.Generator().manual_seed(11)
    adv = (2 * torch.randn(2, 40, generator=g) + 0.5).numpy()
    want = _jax_pmean_normalize(adv)
    for r in range(2):
        np.testing.assert_allclose(res[r]["norm"].numpy(), want[r],
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["bandit", "duel"])
def test_two_ranks_match_the_jit_tiers_two_block_emulation(two_ranks, name):
    _, case, res = two_ranks
    kw = case.RUNS[name]
    e = case.engine("jit", num_shards=2, **kw)
    e.run(kw["updates"] * e.steps_per_update)
    for r in range(2):
        params, m = res[r][name]
        _close_tree(params, e.ts.params, atol=1e-5, rtol=1e-5)
        _close_tree(m, e.ts.opt.m, atol=1e-5, rtol=1e-5)
    # the replicas agree with each other exactly
    assert _equal_tree(res[0][name][0], res[1][name][0])


def test_two_ranks_resume_bit_for_bit(two_ranks):
    d, _, res = two_ranks
    for r in range(2):
        assert res[r]["resumed_at"] == 2
        b, full, bv, fv, bo, fo = res[r]["resume"]
        assert _equal_tree(b, full) and _equal_tree(bv, fv)
        assert torch.equal(bo, fo)
    assert (d / "ck" / "step_2" / "index.json").exists()
    assert (d / "ck" / "step_4" / "index.json").exists()


def test_two_ranks_dead_rank_raises_in_the_survivor(two_ranks):
    d, _, _ = two_ranks
    dead = torch.load(d / "dead.pt")
    assert dead["raised"] is not None and dead["s"] < 30.0, dead


def test_launcher_spawns_two_cpu_ranks(tmp_path):
    from repro_torch.launch import train as train_cli
    res = train_cli.main(["--ocean", "bandit", "--engine-backend",
                          "shard_map", "--devices", "2", "--device", "cpu",
                          "--num-envs", "8", "--total-env-steps", "512",
                          "--full-budget", "--ckpt-dir", str(tmp_path)])
    assert res["bandit"]["env_steps"] == 512
    with pytest.raises(SystemExit):
        train_cli.main(["--ocean", "bandit", "--devices", "2",
                        "--device", "cpu"])          # not the shard_map tier
    with pytest.raises(SystemExit):
        train_cli.main(["--ocean", "bandit", "--mesh", "2x1",
                        "--device", "cpu"])
