"""The port's pool and host training tiers on the CPU.

The counterparts of tests/test_engine.py's pool-tier tests and of
tests/test_host_bridge.py's host-tier engine tests, plus: the host tier's
``_stack_fragments`` equals JAX's exactly, the act step's packed transfer
gives host arrays equal to the device tensors byte for byte, and the
launcher solves bandit on both tiers (``SOLVED``). On the CPU GAE and
``pack`` take their plain versions.
"""
import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.engine import TrainEngine as JTrainEngine
from repro_torch.bridge import make_host_engine, wrap
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.envs import ocean
from repro_torch.envs.ocean_host import HostBandit, HostSquared, HostTeam
from repro_torch.launch import train as train_cli
from repro_torch.rl.engine import TrainEngine, act_transfer_spec
from repro_torch.rl.trainer import Trainer, ocean_policy_stack

TCFG = TrainConfig(num_envs=8, unroll_length=8, update_epochs=1,
                   num_minibatches=2, learning_rate=1e-3, gamma=0.95)
POOL = TrainConfig(num_envs=16, unroll_length=16, update_epochs=2,
                   num_minibatches=2, learning_rate=1e-3, gamma=0.95)


def _pool(env, tcfg=POOL, recurrent=False):
    em, dist, pol = ocean_policy_stack(env, hidden=16, recurrent=recurrent)
    return TrainEngine(em, pol, tcfg, dist, seed=0, device="cpu",
                       backend="pool")


def _host(env_fn, tcfg=TCFG, **kw):
    return make_host_engine(env_fn, tcfg, hidden=16, device="cpu", **kw)


# -- pool tier ---------------------------------------------------------------------

def test_pool_tier_runs_and_accounts():
    tcfg = TrainConfig(**{**POOL.__dict__, "pool_buffers": 3})
    e = _pool(ocean.Bandit(), tcfg)
    hist, solved = e.run(6 * e.steps_per_update)
    assert solved is None and len(hist) == 6
    assert [h["env_steps"] for h in hist] == \
        [(i + 1) * e.steps_per_update for i in range(6)]
    assert all(np.isfinite(h["loss"]) for h in hist)
    # 6 buffer trajectories of 16 steps, across 3 buffers
    assert e.act_steps >= 6 * 16


def test_pool_tier_recurrent_learns_shapes():
    tcfg = TrainConfig(num_envs=8, unroll_length=16, update_epochs=1,
                       num_minibatches=2, learning_rate=1e-3, gamma=0.95)
    e = _pool(ocean.Memory(), tcfg, recurrent=True)
    hist, _ = e.run(4 * e.steps_per_update)
    assert len(hist) == 4 and np.isfinite(hist[-1]["loss"])
    assert e.ts.params["lstm"]["wi"].shape[0] == 16


def test_pool_tier_reusable_after_early_exit():
    """An early exit leaves every recv answered by a send, so the engine
    keeps training."""
    e = _pool(ocean.Bandit())
    hist, solved = e.run(200 * e.steps_per_update, target_score=0.3)
    assert solved is not None and solved["score"] >= 0.3
    assert len(hist) < 200
    hist2, _ = e.run(2 * e.steps_per_update)
    assert len(hist2) == 2


def test_pool_protocol_errors():
    e = _pool(ocean.Bandit())
    pool = e.pool
    with pytest.raises(RuntimeError, match="without recv"):
        pool.send(torch.zeros((16, 1), dtype=torch.int32))
    obs, rew, done, info, b = pool.recv()
    assert obs.shape == (16, 1) and not bool(done.any())
    assert set(info) == {"score", "episode_return", "episode_length",
                         "valid"}
    with pytest.raises(RuntimeError, match="twice"):
        pool.recv()
    with pytest.raises(ValueError, match="awaited buffer"):
        pool.send(torch.zeros((16, 1), dtype=torch.int32), b + 1)
    pool.send(torch.zeros((16, 1), dtype=torch.int32), b)
    assert pool.recv()[4] == (b + 1) % pool.num_buffers


# -- host tier ---------------------------------------------------------------------

def test_host_tier_smoke():
    e = _host(HostBandit)
    try:
        assert e.hvec.num_envs == 2 * TCFG.num_envs     # M = 2N default
        hist, solved = e.run(3 * e.steps_per_update)
        assert solved is None and len(hist) == 3
        assert [h["env_steps"] for h in hist] == \
            [(i + 1) * e.steps_per_update for i in range(3)]
        assert all(np.isfinite(h["loss"]) for h in hist)
        assert e.stats()["pool"]["backend"] == "thread"
    finally:
        e.close()


def test_host_tier_recurrent():
    e = _host(HostSquared, recurrent=True)
    try:
        hist, _ = e.run(2 * e.steps_per_update)
        assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    finally:
        e.close()


def test_host_tier_multiagent():
    tcfg = TrainConfig(**{**TCFG.__dict__, "num_envs": 4})
    e = _host(HostTeam, tcfg)
    try:
        assert e.batch_size == 8                # 4 envs × 2 agent rows
        hist, _ = e.run(2 * e.steps_per_update)
        assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    finally:
        e.close()


def test_host_tier_target_score_early_exit():
    e = _host(HostBandit)
    try:
        hist, solved = e.run(400 * e.steps_per_update, target_score=0.3)
        assert solved is not None and solved["score"] >= 0.3
        assert len(hist) < 400
    finally:
        e.close()


def test_tier_validation(tmp_path):
    # K > 1 is the jit tier's knob
    with pytest.raises(ValueError, match="host tier"):
        _host(HostBandit, TrainConfig(num_envs=8, unroll_length=8,
                                      updates_per_launch=4))
    em, dist, pol = ocean_policy_stack(ocean.Bandit(), hidden=16)
    with pytest.raises(ValueError, match="pool tier"):
        TrainEngine(em, pol, TCFG, dist, device="cpu", backend="pool",
                    updates_per_launch=4)
    # a batched env is not a HostVecEnv
    with pytest.raises(ValueError, match="HostVecEnv"):
        TrainEngine(em, pol, TCFG, dist, device="cpu", backend="host")
    # the bridge batch must match the training config
    v = wrap(HostBandit, num_envs=4)
    try:
        with pytest.raises(ValueError, match="num_envs"):
            TrainEngine(v, pol, TCFG, dist, device="cpu", backend="host")
    finally:
        v.close()
    # the host tier checkpoints at update boundaries (learner + generator)
    e = _host(HostBandit, dataclasses.replace(TCFG, checkpoint_every=1))
    try:
        e.checkpoint_dir = str(tmp_path)
        e.run(e.steps_per_update)
    finally:
        e.close()
    assert ckpt.step_of(ckpt.latest(str(tmp_path))) == 1


def _fragments(rng, Nb, T, A, recurrent, carry):
    frags = []
    for _ in range(Nb):
        rec = []
        for _ in range(T):
            info = {"score": np.float32(rng.random()),
                    "episode_return": np.float32(rng.random()),
                    "episode_length": np.int32(rng.integers(0, 9)),
                    "valid": rng.random() < 0.3}
            rec.append((rng.standard_normal((A, 3)).astype(np.float32),
                        rng.integers(0, 4, (A, 2)).astype(np.int32),
                        rng.standard_normal(A).astype(np.float32),
                        rng.standard_normal(A).astype(np.float32),
                        rng.random(A) < 0.2,
                        rng.standard_normal(A).astype(np.float32),
                        rng.random(A) < 0.2, info))
        c0 = (tuple(carry(rng.standard_normal((A, 5)).astype(np.float32))
                    for _ in range(2)) if recurrent else None)
        frags.append((rec, c0, rng.standard_normal(A).astype(np.float32)))
    return frags


@pytest.mark.parametrize("recurrent", [False, True])
def test_stack_fragments_matches_jax(recurrent):
    T, A, Nb = 4, 2, 3
    tf = _fragments(np.random.default_rng(0), Nb, T, A, recurrent,
                    torch.from_numpy)
    jf = _fragments(np.random.default_rng(0), Nb, T, A, recurrent,
                    jnp.asarray)
    traj, c0, lv = TrainEngine._stack_fragments(tf, T, A, recurrent)
    jtraj, jc0, jlv = JTrainEngine._stack_fragments(jf, T, A, recurrent)
    for g, w in zip(traj[:7], jtraj[:7]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert traj.infos.keys() == jtraj.infos.keys()
    for k in jtraj.infos:
        np.testing.assert_array_equal(traj.infos[k], jtraj.infos[k])
    np.testing.assert_array_equal(lv, jlv)
    if recurrent:
        for g, w in zip(c0, jc0):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        assert c0 is None and jc0 is None


@pytest.mark.parametrize("env_fn", [HostBandit, HostTeam],
                         ids=["bandit", "team"])
def test_act_transfer_equals_the_device_tensors(env_fn):
    """One act step through ``pack`` and the numpy bytes unemulate gives the
    act's action, logp and value byte for byte."""
    e = _host(env_fn, TrainConfig(**{**TCFG.__dict__, "num_envs": 4}))
    try:
        obs, _, done, _, ids = e.hvec.recv(timeout=30.0)
        state = e.generator.get_state()
        want = e._act(e.ts.params, torch.from_numpy(obs),
                      None, torch.from_numpy(done), e.generator)[:3]
        e.generator.set_state(state)
        spec = act_transfer_spec(e.hvec.act_spec)
        assert spec.total == 4 * e.hvec.act_spec.num_components + 8
        got = e._act_to_host(spec, obs, None, done, None)[:3]
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == w.numpy().dtype
            assert g.shape == tuple(w.shape)
            assert g.tobytes() == w.numpy().tobytes()
        assert e.act_steps == 1
        e.hvec.send(got[0], ids)
    finally:
        e.close()


# -- launcher ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("argv", [
    ["--ocean", "bandit", "--engine-backend", "pool"],
    ["--host-env", "bandit"]], ids=["pool", "host"])
def test_cli_solves_bandit_on_the_cpu(argv):
    """The bandit preset (64 envs × 64 steps, hidden 64, seed 0) solves on
    the pool and the host tier within its 150k-step budget."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main(argv + ["--device", "cpu"])
    assert "SOLVED" in out.getvalue(), out.getvalue()
    assert res["bandit"]["score"] >= 0.9


def test_cli_tiers_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--ocean", "bandit", "--engine-backend", "pool"],
                 ["--host-env", "bandit"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_engine(HostBandit, TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(ocean.Bandit(), TCFG, backend="pool")
    with pytest.raises(SystemExit):
        train_cli.main(["--host-env", "bandit", "--engine-backend", "pool",
                        "--device", "cpu"])
