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
                 "continuous", "pong", "drone", "maze")
# state keys the step draws afresh (compared by distribution below)
DRAWN = {"spaces": ("img_bit", "flat_bit"), "bandit": ("ret",),
         "tagteam": ("signal",), "duel": ("coin",)}
# names whose reset draws nothing, so the reset obs compare exactly
FIXED_RESET = ("squared", "password", "stochastic", "multiagent")


@pytest.mark.parametrize("name", list(tocean.OCEAN))
def test_env_step_matches_jax(name):
    """Ten steps of N envs from states the JAX envs reached (with
    autoreset), each step from the same state with the same actions. Where
    the step draws a field (TagTeam's signal, Duel's respawned coin), the
    obs is held to JAX's obs of the port's next state."""
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
        if name in ("tagteam", "duel"):
            want = jax.vmap(jenv._obs)(_jt(ts))
            _assert_equal(tobs, want, f"{name} obs of the port's state")
        elif name != "spaces":      # Spaces shows the new bits
            _assert_equal(tobs, jobs, f"{name} obs")
        if name == "duel":          # the coin stays unless it was taken
            kept = ~np.asarray(jnp.all(js["pos"] == state["coin"][:, None],
                                       -1).any(-1))
            _assert_equal(ts["coin"][torch.from_numpy(kept)],
                          np.asarray(js["coin"])[kept], "duel coin kept")
        # the reset observation of the same states
        _, treset = tenv.reset(_tt(js), gen)
        _, jreset = jax.vmap(jenv.reset)(js, keys)
        if name in FIXED_RESET:
            _assert_equal(treset, jreset, f"{name} reset obs")
        vec_act = act.reshape(-1) if tenv.num_agents > 1 else act
        state, *_ = vec.step(state, vec_act, jax.random.fold_in(key, i))


def _jt(tree):
    """torch tree → JAX tree."""
    if isinstance(tree, dict):
        return {k: _jt(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


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


# -- Ocean II: draws by distribution, pad_agents, invariants, optimal play ------

def _value_freqs(a, b, values, what):
    """The frequency of each of ``values`` in a and b, within 4 SE."""
    a, b = np.asarray(a), np.asarray(b)
    for v in values:
        _freq_close(a == v, b == v, f"{what} == {v}")


def _ocean2_draws(case):
    """(port values, JAX values, what) for one drawn field of Ocean II."""
    gen = torch.Generator().manual_seed(0)
    if case == "pong_init":
        ts, js = tocean.Pong().init(NDIST, gen), _jax_init(jocean.Pong(),
                                                           NDIST)
        return [(ts["ball"][:, 1], js["ball"][:, 1], range(6), "ball col"),
                (ts["dx"], js["dx"], (-1, 0, 1), "dx")]
    if case == "drone_init":
        ts, js = tocean.Drone().init(NDIST, gen), _jax_init(jocean.Drone(),
                                                            NDIST)
        t = ts["target"].numpy()
        assert t.min() >= -0.8 and t.max() <= 0.8
        return [(ts["target"][:, i] > x, js["target"][:, i] > x, (True,),
                 f"target[{i}] > {x}") for i in range(3)
                for x in (-0.4, 0.0, 0.4)]
    if case == "maze_init":
        ts, js = tocean.Maze().init(NDIST, gen), _jax_init(jocean.Maze(),
                                                           NDIST)
        out = [(ts["walls"][:, r, c], js["walls"][:, r, c], (True,),
                f"wall ({r}, {c})") for r in (1, 3, 5) for c in (1, 3, 5)]
        for k in ("pos", "target"):
            cell = lambda x: np.asarray(x)[:, 0] * 7 + np.asarray(x)[:, 1]
            out.append((cell(ts[k]), cell(js[k]),
                        [r * 7 + c for r in range(0, 7, 2)
                         for c in range(0, 7, 2)], k))
        return out
    if case == "tagteam_signal":
        env, jenv = tocean.TagTeam(), jocean.TagTeam()
        ts, js = env.init(NDIST, gen), _jax_init(jenv, NDIST)
        act = np.zeros((NDIST, 6), np.int32)
        keys = jax.random.split(jax.random.PRNGKey(5), NDIST)
        js2 = jax.vmap(jenv.step)(js, act, keys)[0]
        ts2 = env.step(ts, _tt(act), gen)[0]
        return [(ts["signal"], js["signal"], (1,), "init signal"),
                (ts2["signal"], js2["signal"], (1,), "step signal")]
    if case == "duel_init":
        ts, js = tocean.Duel().init(NDIST, gen), _jax_init(jocean.Duel(),
                                                           NDIST)
        return [(ts["pos"][:, a, i], js["pos"][:, a, i], range(5),
                 f"pos[{a}, {i}]") for a in range(2) for i in range(2)] + [
                (ts["coin"][:, i], js["coin"][:, i], range(5), f"coin[{i}]")
                for i in range(2)]
    assert case == "duel_coin"
    # agent 0 stands north of the coin and steps south onto it: every
    # env's coin is taken and respawns at a fresh draw
    env, jenv = tocean.Duel(), jocean.Duel()
    js = _jax_init(jenv, NDIST)
    coin = np.asarray(js["coin"]).copy()
    coin[:, 0] = np.maximum(coin[:, 0], 1)
    pos = np.asarray(js["pos"]).copy()
    pos[:, 0] = coin - np.array([1, 0])
    # agent 1 off the coin: row 0 never holds it
    pos[(pos[:, 1] == coin).all(-1), 1, 0] = 0
    js = dict(js, pos=jnp.asarray(pos), coin=jnp.asarray(coin))
    act = np.tile(np.array([[2, 0]], np.int32), (NDIST, 1))
    keys = jax.random.split(jax.random.PRNGKey(6), NDIST)
    js2 = jax.vmap(jenv.step)(js, act, keys)[0]
    ts2 = env.step(_tt(js), _tt(act), gen)[0]
    assert bool(ts2["caps"][:, 0].eq(1).all())
    return [(ts2["coin"][:, i], js2["coin"][:, i], range(5), f"respawn[{i}]")
            for i in range(2)]


@pytest.mark.parametrize("case", ["pong_init", "drone_init", "maze_init",
                                  "tagteam_signal", "duel_init", "duel_coin"])
def test_ocean2_draws_match_jax_by_distribution(case):
    for t, j, values, what in _ocean2_draws(case):
        _value_freqs(t.numpy() if torch.is_tensor(t) else t, j, values,
                     f"{case} {what}")


@pytest.mark.parametrize("live,agents,trail", [(1, 4, (3,)), (3, 6, (2, 2)),
                                               (4, 4, (5,)), (2, 7, ()),
                                               (5, 6, (4,))])
def test_pad_agents_matches_jax_on_ragged_counts(live, agents, trail):
    rng = np.random.default_rng(live * 10 + agents)
    obs = rng.standard_normal((live,) + trail).astype(np.float32)
    mask = rng.random(live) < 0.7
    jo, jm = jem.pad_agents(jnp.asarray(obs), jnp.asarray(mask), agents)
    to, tm = tem.pad_agents(torch.from_numpy(obs), torch.from_numpy(mask),
                            agents)
    _assert_equal(to, jo, "padded obs")
    _assert_equal(tm, jm, "padded mask")
    assert tm.dtype == torch.bool
    # a batch of envs: the agent axis is 1, each env padded as JAX pads one
    bobs = rng.standard_normal((3, live) + trail).astype(np.float32)
    bmask = rng.random((3, live)) < 0.7
    jo, jm = jax.vmap(lambda o, m: jem.pad_agents(o, m, agents))(
        jnp.asarray(bobs), jnp.asarray(bmask))
    to, tm = tem.pad_agents(torch.from_numpy(bobs), torch.from_numpy(bmask),
                            agents, axis=1)
    _assert_equal(to, jo, "batched padded obs")
    _assert_equal(tm, jm, "batched padded mask")


def _duel_batch(n, seed):
    env = tocean.Duel()
    gen = torch.Generator().manual_seed(seed)
    return env, env.init(n, gen), gen


def test_duel_reward_sums_to_zero_every_step():
    env, s, gen = _duel_batch(256, 0)
    vec = TVecEnv(env, 256)
    s, _ = vec.init(gen)
    for _ in range(80):          # two and a half episodes, autoreset
        act = torch.randint(0, 5, (512,), generator=gen, dtype=torch.int32)
        s, _, rew, _, _ = vec.step(s, act, gen)
        assert torch.equal(rew.reshape(256, 2).sum(-1), torch.zeros(256))


def test_duel_step_commutes_with_swap():
    """step(swap(s), swap(a)) == swap(step(s, a)): rows reversed in the
    state, obs and reward; the same done and coin (the same draws)."""
    env, s, gen = _duel_batch(512, 1)
    for i in range(40):
        a = torch.randint(0, 5, (512, 2), generator=gen, dtype=torch.int32)
        g1 = torch.Generator().manual_seed(100 + i)
        g2 = torch.Generator().manual_seed(100 + i)
        s2, obs, rew, done, _ = env.step(s, a, g1)
        w2, wobs, wrew, wdone, _ = env.step(env.swap_agents(s), a.flip(1), g2)
        _assert_equal(w2, {k: v.numpy() for k, v in
                           env.swap_agents(s2).items()}, "swapped state")
        _assert_equal(wobs, obs.flip(1).numpy(), "swapped obs")
        _assert_equal(wrew, rew.flip(1).numpy(), "swapped reward")
        _assert_equal(wdone, done.numpy(), "done")
        s = s2


def test_maze_draws_a_new_layout_per_episode_through_autoreset():
    """One env of a VecEnv over 64 episodes: the walls stay put within an
    episode and the autoreset draws a new maze for the next."""
    vec = TVecEnv(tem.Emulated(tocean.Maze()), 1)
    gen = torch.Generator().manual_seed(0)
    s, _ = vec.init(gen)
    layouts, episodes = [s["walls"][0].numpy().tobytes()], 0
    while episodes < 64:
        act = torch.randint(0, 5, (1, 1), generator=gen, dtype=torch.int32)
        before = s["walls"][0].clone()
        s, _, _, done, _ = vec.step(s, act, gen)
        if bool(done[0]):
            episodes += 1
            if episodes < 64:
                layouts.append(s["walls"][0].numpy().tobytes())
        else:
            assert torch.equal(s["walls"][0], before)
    assert len(set(layouts)) > 1
    assert len(set(layouts)) > 32          # 512 layouts: few repeats


def test_maze_walls_only_on_pillars_start_and_goal_open():
    s = tocean.Maze().init(256, torch.Generator().manual_seed(3))
    walls = s["walls"].numpy()
    nz = np.nonzero(walls)
    assert np.all(nz[1] % 2 == 1) and np.all(nz[2] % 2 == 1)
    n = np.arange(256)
    for k in ("pos", "target"):
        p = s[k].numpy()
        assert not walls[n, p[:, 0], p[:, 1]].any()
        assert np.all(p % 2 == 0)
    layouts = {w.tobytes() for w in walls[:12]}
    assert len(layouts) > 1


def _run_batched(env, n, policy, seed=0):
    """Roll a hand-written batched policy for one episode of each of n envs;
    returns each env's score at its first done."""
    gen = torch.Generator().manual_seed(seed)
    s, obs = env.reset(env.init(n, gen), gen)
    scores = torch.full((n,), float("nan"))
    for t in range(1000):
        s_prev = s
        s, obs, rew, done, info = env.step(s, policy(s_prev, obs), gen)
        first = done & scores.isnan()
        scores = torch.where(first, info["score"], scores)
        if not bool(scores.isnan().any()):
            return scores
    raise AssertionError("an episode never ended")


def test_pong_greedy_tracking_catches():
    """A memoryless greedy tracker (move toward the ball's current column)
    always catches with the 3-wide paddle."""
    def greedy(s, obs):
        ball, pad = s["ball"][:, 1], s["paddle"]
        return torch.where(ball == pad, 0, torch.where(ball < pad, 1, 2))
    assert float(_run_batched(tocean.Pong(), 100, greedy).mean()) == 1.0


def test_pong_obs_is_pixel_grid():
    env = tocean.Pong()
    gen = torch.Generator().manual_seed(3)
    _, obs = env.reset(env.init(64, gen), gen)
    assert obs.shape == (64, 6, 6)
    assert torch.equal(obs.flatten(1).amax(1), torch.ones(64))   # the ball
    paddle = (obs == 0.5).flatten(1).sum(1)
    assert set(paddle.tolist()) <= {2, 3}       # clipped at a wall: 2


def test_drone_direct_flight_scores_high():
    env = tocean.Drone()

    def direct(s, obs):
        return ((s["target"] - s["pos"]) / env.thrust).clamp(-1, 1)
    assert float(_run_batched(env, 30, direct).mean()) > 0.95


def test_tagteam_per_team_reward_and_padding():
    env = tocean.TagTeam()
    gen = torch.Generator().manual_seed(0)
    s, obs = env.reset(env.init(8, gen), gen)
    assert obs.shape == (8, 6, 4)
    assert torch.equal(obs[:, 4:], torch.zeros(8, 2, 4))         # padded rows
    sig = obs[:, 0, 2].int()
    z = torch.zeros_like(sig)
    # team 0 plays the signal, team 1 misplays: team rewards 1.0 / 0.0
    act = torch.stack([sig, sig, sig, sig, z, z], -1)
    s, obs, rew, done, info = env.step(s, act, gen)
    assert torch.equal(rew, torch.tensor([[1., 1, 0, 0, 0, 0]]).expand(8, 6))
    # one team-0 agent defects: BOTH team-0 agents drop to 0.5 (shared)
    sig = obs[:, 0, 2].int()
    act = torch.stack([sig, 1 - sig, 1 - sig, 1 - sig, z, z], -1)
    s, obs, rew, done, info = env.step(s, act, gen)
    assert torch.equal(rew, torch.tensor([[.5, .5, 1, 1, 0, 0]]).expand(8, 6))


def test_tagteam_optimal_scores_1():
    def optimal(s, obs):
        sig = obs[:, 0, 2].int()
        z = torch.zeros_like(sig)
        return torch.stack([sig, sig, 1 - sig, 1 - sig, z, z], -1)
    assert torch.equal(_run_batched(tocean.TagTeam(), 16, optimal, seed=7),
                       torch.ones(16))


def test_maze_greedy_with_wall_avoidance_solves():
    env = tocean.Maze()
    moves = torch.tensor(tocean._MOVES)

    def greedy(s, obs):
        cand = s["pos"][:, None, :] + moves                      # (N, 5, 2)
        inside = ((cand >= 0) & (cand < 7)).all(-1)
        cc = cand.clamp(0, 6)
        n = torch.arange(cand.shape[0])[:, None]
        wall = s["walls"][n, cc[..., 0], cc[..., 1]]
        cost = (cand - s["target"][:, None, :]).abs().sum(-1)
        cost = torch.where(inside & ~wall, cost, 99)
        return cost.argmin(-1).int()        # first minimum, as min() picks
    assert float(_run_batched(env, 50, greedy, seed=1).mean()) > 0.95


# -- the registry ---------------------------------------------------------------

def test_registry_has_the_reference_names_in_order():
    assert list(tocean.OCEAN) == list(jocean.OCEAN)
    assert len(tocean.OCEAN) == 13
    for name, cls in tocean.OCEAN.items():
        env, jenv = cls(), jocean.OCEAN[name]()
        assert env.num_agents == jenv.num_agents, name
        for t, j in ((env.observation_space, jenv.observation_space),
                     (env.action_space, jenv.action_space)):
            assert type(t).__name__ == type(j).__name__, name
            assert getattr(t, "shape", None) == getattr(j, "shape", None)
            assert getattr(t, "n", None) == getattr(j, "n", None), name
    assert tocean.Pong.obs_frontend == "conv"


def test_launcher_ocean_all_takes_every_env(monkeypatch):
    """``--ocean all`` builds a Trainer for each of the 13 envs, in order,
    each at its preset (the Trainer is replaced: nothing trains)."""
    from repro_torch.configs.ocean import preset
    from repro_torch.launch import train as train_cli
    from repro_torch.rl import trainer as trainer_mod
    seen = []

    class Recorder:
        def __init__(self, env, tcfg, hidden, recurrent, conv, seed, device,
                     log_dir):
            seen.append((type(env).__name__.lower(), hidden, recurrent))
            self.engine = type("E", (), {"close": lambda s: None})()
            self.logger = type("L", (), {"close": lambda s: None})()
            self.history = []

        def train(self, steps, **kw):
            return {"score": 1.0, "env_steps": steps, "sps": 1.0}

    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    out = train_cli.main(["--ocean", "all", "--device", "cpu"])
    assert [s[0] for s in seen] == list(jocean.OCEAN)
    assert list(out) == list(jocean.OCEAN)
    assert all((h, r) == (preset(n).hidden, preset(n).recurrent)
               for (n, h, r) in seen)
