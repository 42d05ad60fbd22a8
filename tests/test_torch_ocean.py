"""The port's batched Ocean envs, emulation and VecEnv against the JAX
package.

Deterministic outputs are compared exactly: the same state (the JAX state
dict → numpy → torch) and the same actions give the same observations,
rewards, dones and infos. Randomness has no shared stream, so what an env
draws (Memory's sequence, Spaces' bits, Bandit's payouts, Continuous'
target) is compared by distribution: a frequency or mean over ≥ 4096 envs,
port against JAX, within 4 standard errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import emulation as jem
from repro.core.vector import VecEnv as JVecEnv
from repro.envs import ocean as jocean
from repro_torch.core import emulation as tem
from repro_torch.core import spaces as tsp
from repro_torch.core.vector import VecEnv as TVecEnv
from repro_torch.envs import ocean as tocean

N = 64          # envs per exact-comparison batch
NDIST = 4096    # envs per distribution comparison


def _tt(tree):
    """JAX/numpy tree → torch tree (CPU, same dtypes)."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_equal(got[k], want[k], f"{what}.{k}")
        return
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=what)


def _actions(env, rng, n):
    space = env.action_space
    if isinstance(space, tsp.Dict):
        return {k: rng.integers(0, s.n, n).astype(np.int32)
                for k, s in space.items()}
    if hasattr(space, "n"):
        shape = (n, env.num_agents) if env.num_agents > 1 else (n,)
        return rng.integers(0, space.n, shape).astype(np.int32)
    return rng.uniform(-1.5, 1.5, (n,) + space.shape).astype(np.float32)


# names whose step is deterministic given the state and the action
DETERMINISTIC = ("squared", "password", "stochastic", "memory", "multiagent",
                 "continuous")
# state keys the step draws afresh (compared by distribution below)
DRAWN = {"spaces": ("img_bit", "flat_bit"), "bandit": ("ret",)}


@pytest.mark.parametrize("name", list(tocean.OCEAN))
def test_env_step_matches_jax(name):
    """Ten steps of N envs from states the JAX envs reached (with
    autoreset), each step from the same state with the same actions."""
    jenv, tenv = jocean.OCEAN[name](), tocean.OCEAN[name]()
    assert tenv.num_agents == jenv.num_agents
    vec = JVecEnv(jenv, N)
    key = jax.random.PRNGKey(0)
    state, _ = vec.init(key)
    vstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    for i in range(10):
        act = _actions(tenv, rng, N)
        keys = jax.random.split(jax.random.fold_in(key, 100 + i), N)
        js, jobs, jrew, jdone, jinfo = vstep(state, act, keys)
        ts, tobs, trew, tdone, tinfo = tenv.step(_tt(state), _tt(act), gen)
        _assert_equal(tdone, jdone, f"{name} done")
        _assert_equal(tinfo["valid"], jinfo["valid"], f"{name} valid")
        _assert_equal(tinfo["episode_length"], jinfo["episode_length"],
                      f"{name} episode_length")
        drawn = DRAWN.get(name, ())
        for k in js:
            if k not in drawn:
                _assert_equal(ts[k], js[k], f"{name} state {k}")
        if name != "bandit":        # Bandit's payout is drawn
            _assert_equal(trew, jrew, f"{name} reward")
            _assert_equal(tinfo, jinfo, f"{name} info")
        if name != "spaces":        # Spaces shows the new bits
            _assert_equal(tobs, jobs, f"{name} obs")
        # the reset observation of the same states
        _, treset = tenv.reset(_tt(js), gen)
        _, jreset = jax.vmap(jenv.reset)(js, keys)
        if name in DETERMINISTIC and name not in ("memory", "continuous"):
            _assert_equal(treset, jreset, f"{name} reset obs")
        vec_act = act.reshape(-1) if tenv.num_agents > 1 else act
        state, *_ = vec.step(state, vec_act, jax.random.fold_in(key, i))


def _freq_close(a, b, what):
    """Two sample means within 4 combined standard errors."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    se = np.sqrt(a.var() / a.size + b.var() / b.size) + 1e-12
    assert abs(a.mean() - b.mean()) <= 4 * se, (what, a.mean(), b.mean(), se)


def _jax_init(env, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(env.init)(keys)


def test_memory_sequence_distribution():
    jenv, tenv = jocean.Memory(), tocean.Memory()
    js = _jax_init(jenv, NDIST)
    ts = tenv.init(NDIST, torch.Generator().manual_seed(0))
    assert ts["seq"].shape == (NDIST, jenv.length)
    assert ts["seq"].dtype == torch.int32
    _freq_close(ts["seq"].numpy(), np.asarray(js["seq"]), "memory bits")
    # the observation shows the drawn sequence, one symbol per step
    np.testing.assert_array_equal(
        tenv.obs(ts).argmax(-1).numpy(), ts["seq"][:, 0].numpy() + 1)


def test_spaces_bits_distribution():
    jenv, tenv = jocean.Spaces(), tocean.Spaces()
    gen = torch.Generator().manual_seed(0)
    js = _jax_init(jenv, NDIST)
    ts = tenv.init(NDIST, gen)
    act = {"a": np.zeros(NDIST, np.int32), "b": np.ones(NDIST, np.int32)}
    keys = jax.random.split(jax.random.PRNGKey(3), NDIST)
    js2, jobs, *_ = jax.vmap(jenv.step)(js, act, keys)
    ts2, tobs, *_ = tenv.step(ts, _tt(act), gen)
    for k in ("img_bit", "flat_bit"):
        _freq_close(ts[k].numpy(), np.asarray(js[k]), f"init {k}")
        _freq_close(ts2[k].numpy(), np.asarray(js2[k]), f"step {k}")
    # the observation carries the new bits where the reference puts them
    np.testing.assert_array_equal(tobs["image"][:, 1, 1].numpy(),
                                  ts2["img_bit"].float().numpy())
    np.testing.assert_array_equal(tobs["flat"][:, 0].numpy(),
                                  ts2["flat_bit"].float().numpy())
    assert float(tobs["image"].sum()) == float(ts2["img_bit"].sum())


@pytest.mark.parametrize("arm", range(4))
def test_bandit_payout_distribution(arm):
    jenv, tenv = jocean.Bandit(), tocean.Bandit()
    gen = torch.Generator().manual_seed(arm)
    js = _jax_init(jenv, NDIST)
    act = np.full(NDIST, arm, np.int32)
    keys = jax.random.split(jax.random.PRNGKey(10 + arm), NDIST)
    _, _, jrew, *_ = jax.vmap(jenv.step)(js, act, keys)
    _, _, trew, *_ = tenv.step(_tt(js), _tt(act), gen)
    assert set(np.unique(trew.numpy())) <= {0.0, 1.0}
    _freq_close(trew.numpy(), np.asarray(jrew), f"arm {arm}")


def test_continuous_target_distribution():
    jenv, tenv = jocean.Continuous(), tocean.Continuous()
    js = _jax_init(jenv, NDIST)
    ts = tenv.init(NDIST, torch.Generator().manual_seed(0))
    t, j = ts["target"].numpy(), np.asarray(js["target"])
    assert t.min() >= -0.8 and t.max() <= 0.8
    _freq_close(t, j, "target mean")
    _freq_close(np.abs(t), np.abs(j), "target |mean|")


# -- emulation ------------------------------------------------------------------

def _spaces_obs(n, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 3, 3)).astype(np.float32),
            "flat": rng.standard_normal((n, 4)).astype(np.float32)}


def test_emulate_dict_obs_matches_jax_and_round_trips():
    space = tocean.Spaces().observation_space
    spec_t = tem.flat_spec(space)
    spec_j = jem.flat_spec(jocean.Spaces().observation_space)
    obs = _spaces_obs(16, 0)
    flat_t = tem.emulate(spec_t, _tt(obs))
    flat_j = jem.emulate(spec_j, obs)
    _assert_equal(flat_t, flat_j, "flat obs")
    assert flat_t.shape == (16, 13)      # sorted keys: flat (4) ‖ image (9)
    _assert_equal(tem.unemulate(spec_t, flat_t), obs, "unemulated obs")
    _assert_equal(tem.unemulate(spec_t, flat_t),
                  _np(jem.unemulate(spec_j, flat_j)), "vs jax unemulate")


def test_emulate_dict_action_matches_jax_and_round_trips():
    aspace = tocean.Spaces().action_space
    spec_t = tem.action_spec(aspace)
    spec_j = jem.action_spec(jocean.Spaces().action_space)
    assert spec_t.nvec == spec_j.nvec == (2, 2)
    flat = np.random.default_rng(0).integers(0, 2, (16, 2)).astype(np.int32)
    tree_t = tem.unemulate_action(spec_t, torch.from_numpy(flat))
    tree_j = jem.unemulate_action(spec_j, jnp.asarray(flat))
    _assert_equal(tree_t, _np(tree_j), "action tree")
    _assert_equal(tem.emulate_action(spec_t, tree_t), flat, "round trip")


def test_space_sample_draws_batched_elements():
    gen = torch.Generator().manual_seed(0)
    obs = tsp.sample(tocean.Spaces().observation_space, gen, (16,))
    assert obs["image"].shape == (16, 3, 3) and obs["flat"].shape == (16, 4)
    assert obs["image"].dtype == torch.float32
    assert float(obs["image"].min()) >= 0 and float(obs["image"].max()) < 1
    assert tem.emulate(tem.flat_spec(tocean.Spaces().observation_space),
                       obs).shape == (16, 13)
    act = tsp.sample(tocean.Spaces().action_space, gen, (NDIST,))
    assert act["a"].dtype == torch.int32
    assert set(act["a"].unique().tolist()) == {0, 1}
    box = tsp.sample(tocean.Continuous().action_space, gen, (NDIST,))
    assert box.shape == (NDIST, 1)
    assert float(box.min()) >= -1.0 and float(box.max()) <= 1.0
    _freq_close(box.numpy(), np.zeros(NDIST), "uniform on [-1, 1]")


def test_emulated_env_and_bytes_mode():
    em = tem.Emulated(tocean.Spaces())
    state, obs = em.reset(em.init(8, torch.Generator().manual_seed(0)),
                          torch.Generator().manual_seed(1))
    assert obs.shape == (8, 13) and obs.dtype == torch.float32
    act = torch.zeros((8, 2), dtype=torch.int32)
    _, obs2, rew, done, info = em.step(state, act, torch.Generator())
    assert obs2.shape == (8, 13) and rew.shape == (8,)
    assert set(info) == {"score", "episode_return", "episode_length", "valid"}
    # bytes mode: the same step, the obs as its 13 f32 leaves' 52 bytes
    eb = tem.Emulated(tocean.Spaces(), mode="bytes")
    state, obs = eb.reset(eb.init(8, torch.Generator().manual_seed(0)),
                          torch.Generator().manual_seed(1))
    assert obs.shape == (8, 52) and obs.dtype == torch.uint8
    _, obs2, rew, done, info = eb.step(state, act, torch.Generator())
    assert obs2.shape == (8, 52) and obs2.dtype == torch.uint8
    assert rew.shape == (8,)


# -- vector -----------------------------------------------------------------------

def test_vecenv_multiagent_agent_major_layout_matches_jax():
    n = 4
    tv = TVecEnv(tem.Emulated(tocean.Multiagent()), n)
    jv = JVecEnv(jem.Emulated(jocean.Multiagent()), n)
    assert tv.batch_size == jv.batch_size == 2 * n
    gen = torch.Generator().manual_seed(0)
    ts, tobs = tv.init(gen)
    js, jobs = jv.init(jax.random.PRNGKey(0))
    _assert_equal(tobs, jobs, "init obs")
    # agent-major: rows 2e and 2e+1 are env e's agents 0 and 1
    np.testing.assert_array_equal(tobs[0::2].numpy(), [[1, 0]] * n)
    rng = np.random.default_rng(0)
    for i in range(9):              # horizon 8: autoreset at step 8
        act = rng.integers(0, 2, (2 * n, 1)).astype(np.int32)
        ts, tobs, trew, tdone, tinfo = tv.step(ts, torch.from_numpy(act), gen)
        js, jobs, jrew, jdone, jinfo = jv.step(js, jnp.asarray(act),
                                               jax.random.PRNGKey(i))
        assert trew.shape == (2 * n,) and tdone.shape == (2 * n,)
        assert tinfo["score"].shape == (n,)
        for a, b, what in ((tobs, jobs, "obs"), (trew, jrew, "reward"),
                           (tdone, jdone, "done"), (tinfo, jinfo, "info"),
                           (ts, js, "state")):
            _assert_equal(a, b, f"step {i} {what}")
    assert bool(tdone.any()) is False and int(ts["t"][0]) == 1


def test_vecenv_autoreset_selects_reset_state_where_done():
    n = 5
    tv = TVecEnv(tem.Emulated(tocean.Password()), n)
    jv = JVecEnv(jem.Emulated(jocean.Password()), n)
    gen = torch.Generator().manual_seed(0)
    ts, _ = tv.init(gen)
    ts["t"] = torch.arange(n, dtype=torch.int32)      # one env at each t
    ts["ok"] = torch.tensor([True, False, True, True, False])
    js = {k: jnp.asarray(v.numpy()) for k, v in ts.items()}
    act = np.array([[1], [0], [1], [1], [0]], np.int32)
    ts2, tobs, trew, tdone, tinfo = tv.step(ts, torch.from_numpy(act), gen)
    js2, jobs, jrew, jdone, jinfo = jv.step(js, jnp.asarray(act),
                                            jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tdone.numpy(), [0, 0, 0, 0, 1])
    np.testing.assert_array_equal(ts2["t"].numpy(), [1, 2, 3, 4, 0])
    for a, b, what in ((tobs, jobs, "obs"), (trew, jrew, "reward"),
                       (tdone, jdone, "done"), (tinfo, jinfo, "info"),
                       (ts2, js2, "state")):
        _assert_equal(a, b, what)
