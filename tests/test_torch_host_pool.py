"""The port's host pools and HostBridge against the JAX package.

With the same seeds and the same scripted actions the port's ``HostPool``
and JAX's return the same obs/rew/done/info/ids streams, bitwise, on the
thread and the proc backend. The protocol tests are the counterparts of
tests/test_host_bridge.py's: first finisher, crash propagation, the recv
timeout, close, seeding across autoreset, terminal info and dead proc
workers. Every blocking call carries a timeout and every pool is closed in
a ``finally``, so a hung worker fails one test, never the suite; proc pools
spawn at most 4 workers.

The helper envs of tests/host_envs.py are shared with the reference's
tests: module-level, so spawn workers unpickle them by reference.
"""
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from host_envs import CrashyEnv, JitterEnv, SlowEnv

from repro import bridge as jbridge
from repro.core import emulation as jem
from repro.core import spaces as jsp
from repro.envs import ocean_host as jhost
from repro_torch import bridge
from repro_torch.core import emuspec as tem
from repro_torch.core import shm
from repro_torch.core import spaces as tsp
from repro_torch.core.host import HostEnvError, HostPool, ProcHostPool
from repro_torch.envs import ocean_host as thost

RECV_T = 30.0          # generous per-call bound; hit only on regressions
BACKENDS = ("thread", "proc")
SRC = Path(__file__).resolve().parent.parent / "src"


def _workers_dead(pool) -> bool:
    ws = pool._procs if isinstance(pool, ProcHostPool) else pool._threads
    return not any(w.is_alive() for w in ws)


# -- streams against the reference ---------------------------------------------

def _actions(name, rng, M):
    if name == "team":
        return rng.integers(0, 2, size=(2 * M, 1)).astype(np.int32)
    n = 4 if name == "bandit" else 5
    return rng.integers(0, n, size=(M, 1)).astype(np.int32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["bandit", "squared", "team"])
def test_host_pool_streams_match_jax_bitwise(name, backend):
    """Sync mode (M = N): 40 steps of scripted actions, crossing autoresets
    (horizons 16, 32 and 8); every field of every batch is bitwise equal."""
    M = 2
    kw = dict(num_envs=M, seed=7, recv_timeout=RECV_T, backend=backend)
    vt = bridge.wrap(thost.OCEAN_HOST[name], **kw)
    try:
        vj = jbridge.wrap(jhost.OCEAN_HOST[name], **kw)
        try:
            np.testing.assert_array_equal(vt.reset(), vj.reset())
            rng = np.random.default_rng(0)
            for t in range(40):
                acts = _actions(name, rng, M)
                got = vt.step(acts, timeout=RECV_T)
                want = vj.step(acts, timeout=RECV_T)
                for g, w, what in zip(got[:3], want[:3],
                                      ("obs", "rew", "done")):
                    assert g.dtype == w.dtype, what
                    assert np.array_equal(g, w), f"{what} at step {t}"
                assert got[3].keys() == want[3].keys()
                for k in want[3]:
                    assert np.array_equal(got[3][k], want[3][k]), k
                np.testing.assert_array_equal(vt.last_ids, vj.last_ids)
        finally:
            vj.close()
    finally:
        vt.close()


# -- bridge -----------------------------------------------------------------------

def test_detect_api_and_convert_space_match_jax():
    for name in thost.OCEAN_HOST:
        assert bridge.detect_api(thost.OCEAN_HOST[name]()) == \
            jbridge.detect_api(jhost.OCEAN_HOST[name]())

    class N:                     # gymnasium-shaped duck objects
        n = 5

    class MD:
        nvec = np.array([2, 3])

    class MultiBinary:
        n = (2, 2)

    class B:
        shape, dtype = (4, 2), np.float32
        low, high = -1.0, 1.0

    class D:
        spaces = {"b": B(), "a": N()}

    class T:
        spaces = [MD(), N()]

    for obj in (N(), MD(), MultiBinary(), B(), D(), T()):
        got, want = bridge.convert_space(obj), jbridge.convert_space(obj)
        assert tem.flat_spec(got, "bytes").total == \
            jem.flat_spec(want, "bytes").total
        assert repr(got).replace("repro_torch", "repro") == repr(want)
    assert bridge.convert_space(tsp.Discrete(3)) == tsp.Discrete(3)
    with pytest.raises(TypeError, match="repro_torch.core.spaces"):
        bridge.convert_space(object())


def test_np_emulation_twins_match_jax():
    tspace = tsp.Dict({"image": tsp.Box((3, 3)), "flat": tsp.Box((4,))})
    jspace = jsp.Dict({"image": jsp.Box((3, 3)), "flat": jsp.Box((4,))})
    x = {"image": np.arange(9, dtype=np.float32).reshape(3, 3),
         "flat": np.arange(4, dtype=np.float32) - 2.5}
    np.testing.assert_array_equal(
        bridge.np_emulate_obs(tem.flat_spec(tspace, "f32"), x),
        jbridge.np_emulate_obs(jem.flat_spec(jspace, "f32"), x))
    for tsp_a, jsp_a, flat in (
            (tsp.Dict({"a": tsp.Discrete(2), "b": tsp.MultiDiscrete((3, 4))}),
             jsp.Dict({"a": jsp.Discrete(2), "b": jsp.MultiDiscrete((3, 4))}),
             np.asarray([1, 2, 3], np.int32)),
            (tsp.Box((3,)), jsp.Box((3,)),
             np.asarray([0.5, -1.0, 2.0], np.float32))):
        got = bridge.np_unemulate_action(tem.action_spec(tsp_a), flat)
        want = jbridge.np_unemulate_action(jem.action_spec(jsp_a), flat)
        if isinstance(want, dict):
            assert got["a"] == want["a"] and isinstance(got["a"], int)
            np.testing.assert_array_equal(got["b"], want["b"])
        else:
            np.testing.assert_array_equal(got, want)


def test_np_unemulate_bytes_inverts_emulate():
    """The numpy bytes twin cuts the leaves the port's ``emulate`` packed,
    bitwise, with its own memory (the source may be overwritten)."""
    from repro_torch.core.emulation import emulate
    spec = tem.flat_spec(tsp.Dict({"action": tsp.Box((3,), np.int32),
                                   "logp": tsp.Box(()),
                                   "ok": tsp.Box((2,), np.bool_)}), "bytes")
    rng = np.random.default_rng(0)
    tree = {"action": rng.integers(-9, 9, (5, 3)).astype(np.int32),
            "logp": rng.standard_normal(5).astype(np.float32),
            "ok": rng.random((5, 2)) < 0.5}
    flat = emulate(spec, {k: torch.from_numpy(v) for k, v in tree.items()})
    buf = flat.numpy().copy()
    back = bridge.np_unemulate_bytes(spec, buf)
    buf[:] = 0
    for k, v in tree.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="uint8"):
        bridge.np_unemulate_bytes(spec, buf[:, :-1])


def test_wrap_three_apis():
    for cls, api, obs_shape, act in (
            (thost.HostBandit, "duck", (3, 1), np.zeros((3, 1), np.int32)),
            (thost.HostDrone, "gymnasium", (3, 6),
             np.zeros((3, 3), np.float32)),
            (thost.HostTeam, "pettingzoo", (6, 2),
             np.tile(np.asarray([[0], [1]], np.int32), (3, 1)))):
        v = bridge.wrap(cls, num_envs=3)
        try:
            assert v.pool.__class__ is HostPool and v.is_sync
            obs = v.reset(timeout=RECV_T)
            assert obs.shape == obs_shape and obs.dtype == np.float32
            obs, rew, done, info = v.step(act, timeout=RECV_T)
            assert rew.shape == (obs_shape[0],) and done.dtype == bool
            if api == "pettingzoo":
                np.testing.assert_allclose(rew, 1.0)
        finally:
            v.close()
    with pytest.raises(ValueError, match="factory"):
        bridge.wrap(thost.HostBandit(), num_envs=2)


# -- pool semantics -----------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_first_finisher_batching(backend):
    """M = 2N jittered envs: batches are N distinct envs, sorted, and every
    env gets served."""
    v = bridge.wrap(JitterEnv, num_envs=4, batch_size=2, seed=0,
                    backend=backend)
    seen = set()
    try:
        deadline = time.monotonic() + RECV_T
        while seen != set(range(4)) and time.monotonic() < deadline:
            obs, rew, done, info, ids = v.recv(timeout=RECV_T)
            assert len(ids) == 2 and len(set(ids.tolist())) == 2
            assert sorted(ids.tolist()) == ids.tolist()
            seen.update(int(i) for i in ids)
            v.send(np.zeros((2, 1), np.int32), ids)
    finally:
        v.close()
    assert seen == set(range(4))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["step", "reset"])
def test_crash_propagation(backend, op):
    if op == "step":
        v = bridge.wrap(functools.partial(CrashyEnv, crash_step=2),
                        num_envs=2, backend=backend)
    else:       # api="duck" skips wrap()'s probe reset, which would crash
        v = bridge.wrap(functools.partial(CrashyEnv, crash_reset=True),
                        num_envs=1, backend=backend, api="duck")
    try:
        with pytest.raises(HostEnvError, match=rf"env [01] raised in {op}"):
            v.reset(timeout=RECV_T)
            for _ in range(4):
                v.step(np.zeros((2, 1), np.int32), timeout=RECV_T)
    finally:
        v.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_recv_timeout_guard(backend):
    v = bridge.wrap(functools.partial(SlowEnv, step_s=30.0), num_envs=1,
                    backend=backend)
    try:
        v.reset(timeout=RECV_T)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="0/1 envs ready"):
            v.step(np.zeros((1, 1), np.int32), timeout=0.2)
        assert time.monotonic() - t0 < 5.0
    finally:
        t0 = time.monotonic()
        v.close(timeout=0.5)
        assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_close_joins_idle_workers(backend):
    v = bridge.wrap(thost.HostBandit, num_envs=4, backend=backend)
    v.reset(timeout=RECV_T)
    t0 = time.monotonic()
    v.close(timeout=5.0)
    assert time.monotonic() - t0 < 5.0
    assert _workers_dead(v.pool)
    v.close()                                   # idempotent


@pytest.mark.parametrize("backend", BACKENDS)
def test_seeding_across_autoreset_and_terminal_info(backend):
    """Same seeds replay the same rewards across episode ends (the per-env
    seed sequence seed + i + M·e); other seeds diverge; the episode end
    surfaces its stats with valid == done."""
    def stream(seed):
        v = bridge.wrap(thost.HostBandit, num_envs=2, seed=seed,
                        backend=backend)
        try:
            v.reset(timeout=RECV_T)
            rows, infos = [], []
            for _ in range(40):                 # horizon 16: two resets
                _o, rew, done, info = v.step(np.full((2, 1), 3, np.int32),
                                             timeout=RECV_T)
                rows.append(rew.copy())
                infos.append((done.copy(), info))
        finally:
            v.close()
        return np.stack(rows), infos

    (a, infos), (b, _), (c, _) = stream(0), stream(0), stream(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    for t, (done, info) in enumerate(infos):
        ended = t in (15, 31)
        assert done.all() == ended and info["valid"].all() == ended
        assert (info["valid"] == done).all()
    ret = a[:16].sum(0)
    np.testing.assert_array_equal(infos[15][1]["episode_length"], 16)
    np.testing.assert_allclose(infos[15][1]["episode_return"], ret)
    np.testing.assert_allclose(infos[15][1]["score"],
                               np.minimum(1.0, ret / (16 * 0.9)), rtol=1e-6)


def test_stats_and_liveness():
    v = bridge.wrap(thost.HostBandit, num_envs=2)
    try:
        v.reset(timeout=RECV_T)
        v.step(np.zeros((2, 1), np.int32), timeout=RECV_T)
        st = v.pool.stats()
        assert st["backend"] == "thread" and st["steps"] == 2
        assert st["liveness"]["dead"] == []
    finally:
        v.close()


# -- proc-backend hardening ------------------------------------------------------

def test_proc_dead_worker_fails_send_and_recv():
    v = bridge.wrap(thost.HostBandit, num_envs=2, backend="proc")
    try:
        v.reset(timeout=RECV_T)
        assert v.pool.stats()["workers_detail"]["rows"] == 2
        v.pool._procs[1].terminate()
        v.pool._procs[1].join()
        with pytest.raises(HostEnvError, match="dead"):
            v.send(np.zeros((2, 1), np.int32), np.asarray([0, 1]))
    finally:
        v.close()
    v = bridge.wrap(functools.partial(SlowEnv, step_s=30.0), num_envs=1,
                    backend="proc")
    try:
        v.reset(timeout=RECV_T)
        v.send(np.zeros((1, 1), np.int32), np.asarray([0]))
        v.pool._procs[0].terminate()
        v.pool._procs[0].join()
        with pytest.raises(HostEnvError, match="died without reporting"):
            v.recv(timeout=RECV_T)
    finally:
        v.close()


def test_proc_requires_slab_and_factory():
    with pytest.raises(ValueError, match="slab"):
        HostPool([thost.HostBandit], batch_size=1, backend="proc")
    with pytest.raises(ValueError, match="factory"):
        bridge.wrap(thost.HostBandit(), num_envs=1, backend="proc")


def test_worker_main_refuses_a_forked_child_of_a_cuda_parent(monkeypatch):
    """Called inline, the worker entrypoint runs; as the forked child of a
    process that initialised CUDA (what ``_is_in_bad_fork`` reports) it
    refuses before it touches the slab."""
    cfg = shm.WorkerConfig(shm_name="nonexistent", index=0, M=1, seed=0,
                           spec=shm.SlabSpec(obs_shape=(1,), act_shape=(1,)))
    with pytest.raises(FileNotFoundError):
        shm.worker_main(cfg)                   # not forked: goes on, no slab
    monkeypatch.setattr(torch.cuda, "_is_in_bad_fork", lambda: True)
    with pytest.raises(RuntimeError, match="spawn"):
        shm.worker_main(cfg)


def test_worker_import_chain_stays_torch_free():
    """The spawn-worker import chain (shm, emuspec, spaces, the bridge, the
    mirror envs, procstats, and the launcher that spawn re-imports as
    ``__mp_main__``) never imports torch. Probed in a clean interpreter."""
    code = ("import sys; "
            "import repro_torch.core.shm, repro_torch.core.emuspec, "
            "repro_torch.core.spaces, repro_torch.bridge, "
            "repro_torch.envs.ocean_host, repro_torch.telemetry.procstats, "
            "repro_torch.launch.train; "
            "assert 'torch' not in sys.modules, 'torch leaked into the chain'")
    r = subprocess.run([sys.executable, "-c", code], timeout=120,
                       capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.returncode == 0, r.stderr
