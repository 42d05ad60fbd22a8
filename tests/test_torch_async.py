"""The port's async actor–learner tier on the CPU (``distributed/
actor_learner.py``, the engine's ``async`` branch, ``rl/learner.py::
make_vtrace_adv``) and the telemetry it ships with (``telemetry/{spans,
traceprop,registry,timers,procstats}.py``).

Unit layer: the slab layout and param specs, the seqlock publish/read round
trip and a torn-read retry, ``stack_fragments`` and V-trace against the JAX
package live on the same numpy inputs (f32, atol 1e-5), the staleness
filter, a poisoned publish, the fork guard and the torch-free import chain.
Integration layer: spawned actors (2 per engine, CPU) — accounting and one
trace over the learner and the actors, bandit solving, a killed actor
resharded without a hang, and a killed-then-resumed learner ending at the
uninterrupted update count. Every wait is bounded and every engine closed
in a ``finally``.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.distributed import actor_learner as jal
from repro.models import policy as jpolicy
from repro.rl import distributions as jD
from repro.rl import learner as jlearner
from repro.rl.rollout import Trajectory as JTrajectory
from repro_torch import telemetry
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.ocean import ocean_tcfg
from repro_torch.core import shm
from repro_torch.distributed import actor_learner as al
from repro_torch.envs import ocean
from repro_torch.models import policy as tpolicy
from repro_torch.models.convert import ocean_params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl import distributions as tD
from repro_torch.rl.engine import TrainEngine
from repro_torch.rl.learner import make_vtrace_adv
from repro_torch.rl.rollout import Trajectory
from repro_torch.rl.trainer import ocean_policy_stack
from repro_torch.telemetry import TierTimer, traceprop
from repro_torch.telemetry.procstats import (ACTOR_FIELDS, STALENESS_EDGES,
                                             StatSlab)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=0)


def _spec(leaves=None, **kw):
    leaves = leaves if leaves is not None else [
        torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16)]
    pspecs, pbytes = al.make_param_specs(leaves)
    base = dict(num_actors=2, num_shards=2, slots=2, unroll=4,
                envs_per_shard=3, num_agents=1, obs_dim=6, act_dim=1,
                act_dtype="int32", param_specs=pspecs, param_bytes=pbytes,
                param_names=tuple(f"l{i}" for i in range(len(leaves))))
    base.update(kw)
    return al.FragSpec(**base)


# ------------------------------ unit layer -----------------------------------

def test_param_specs_aligned_and_disjoint():
    leaves = [torch.zeros(3), torch.zeros(2, 2, dtype=torch.float64),
              torch.zeros(5, dtype=torch.int8), torch.zeros(()),
              torch.zeros(3, dtype=torch.bfloat16), np.zeros(4, np.int32)]
    specs, total = al.make_param_specs(leaves)
    prev_end = 0
    for (shape, dtype, off), leaf in zip(specs, leaves):
        assert off % 8 == 0                   # frombuffer-legal for any dtype
        assert off >= prev_end                # no overlap
        assert shape == tuple(leaf.shape)
        prev_end = off + int(np.prod(shape)) * al.itemsize(dtype)
    assert [s[1] for s in specs] == ["float32", "float64", "int8", "float32",
                                     "bfloat16", "int32"]
    assert total == prev_end


def test_async_layout_sections_disjoint_and_viewable():
    lay = al.AsyncLayout(_spec())
    spans = sorted((start, start + np.dtype(dt).itemsize *
                    int(np.prod(shape, dtype=np.int64)), name)
                   for name, (start, shape, dt) in lay.sections.items())
    for (_, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
        assert e0 <= s1, (n0, n1)
    buf = bytearray(lay.nbytes)
    v = lay.views(buf)
    assert v["obs"].shape == (2, 2, 4, 3, 6)
    assert v["fctrl"].shape == (2, 2)
    v["obs"][1, 1, 3, 2, 5] = 7.0            # writes land in the buffer
    assert lay.views(buf)["obs"][1, 1, 3, 2, 5] == 7.0
    assert [p.nbytes for p in lay.param_views(buf)] == [60, 14]


def _publish_target(spec):
    """A learner-side stand-in holding just the slab ``publish`` writes."""
    lay = al.AsyncLayout(spec)
    buf = bytearray(lay.nbytes)
    return SimpleNamespace(_v=lay.views(buf), _pviews=lay.param_views(buf))


def test_seqlock_publish_read_roundtrip_any_dtype():
    """publish copies each leaf's raw bytes; the actor's read rebuilds them
    bit for bit, bf16 and nested key paths included."""
    params = {"enc": torch.arange(15.0).reshape(3, 5),
              "lstm": {"wi": (torch.arange(7) / 3).to(torch.bfloat16)}}
    names = tuple(n for n, _ in ckpt._flatten_with_names(params))
    leaves = [leaf for _, leaf in ckpt._flatten_with_names(params)]
    spec = _spec(leaves, param_names=names)
    tgt = _publish_target(spec)
    al.AsyncRollouts.publish(tgt, params, 3)
    assert tgt.version == 3 and int(tgt._v["pseq"][0]) == 2
    raw, ver = al.read_params_seqlock(tgt._v, tgt._pviews, shm.SpinConfig())
    assert ver == 3
    back = al.params_from_bytes(spec, raw, "cpu")
    assert torch.equal(back["enc"], params["enc"])
    assert back["lstm"]["wi"].dtype == torch.bfloat16
    assert torch.equal(back["lstm"]["wi"], params["lstm"]["wi"])


def test_seqlock_torn_read_retries_until_commit():
    """A reader that arrives mid-write (odd counter) spins until the write
    commits and then sees the *new* leaves, never a torn mix."""
    spec = _spec([torch.zeros(3, 5), torch.zeros(7)])
    lay = al.AsyncLayout(spec)
    buf = bytearray(lay.nbytes)
    v, pviews = lay.views(buf), lay.param_views(buf)
    v["pseq"][0] = 1                          # writer mid-flight
    pviews[0][:] = 1

    def finish_write():
        time.sleep(0.05)
        pviews[0][:] = 2
        pviews[1][:] = 2
        v["pver"][0] = 9
        v["pseq"][0] = 2                      # commit

    t = threading.Thread(target=finish_write)
    t.start()
    slab = StatSlab.create(1, ACTOR_FIELDS, STALENESS_EDGES)
    try:
        row = slab.row(0)
        leaves, ver = al.read_params_seqlock(v, pviews, shm.SpinConfig(),
                                             row)
        t.join(timeout=10)
        assert ver == 9
        assert np.all(leaves[0] == 2) and np.all(leaves[1] == 2)
        assert slab.aggregate()["total"]["seqlock_retries"] > 0
        del row
    finally:
        slab.close()


def test_poisoned_publish_raises_before_touching_the_slab():
    spec = _spec([torch.zeros(3, 5), torch.zeros(7)])
    tgt = _publish_target(spec)
    al.AsyncRollouts.publish(tgt, {"a": torch.ones(3, 5),
                                   "b": torch.ones(7)}, 1)
    before = bytes(tgt._v["params"])

    class Poisoned:
        def detach(self):
            raise RuntimeError("device error surfaced at the host copy")

    with pytest.raises(RuntimeError, match="device error"):
        al.AsyncRollouts.publish(tgt, {"a": torch.zeros(3, 5),
                                       "b": Poisoned()}, 2)
    assert int(tgt._v["pseq"][0]) == 2 and int(tgt._v["pver"][0]) == 1
    assert bytes(tgt._v["params"]) == before


def _frags(n, T=3, R=2, E=2, obs_dim=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = lambda *s: rng.standard_normal(s).astype(np.float32)
        out.append(dict(
            shard=i, actor=0, version=i, seq=0, obs=f(T, R, obs_dim),
            actions=rng.integers(0, 3, (T, R, 1)).astype(np.int32),
            logprobs=f(T, R), values=f(T, R), rewards=f(T, R),
            dones=rng.random((T, R)) < 0.3, resets=rng.random((T, R)) < 0.3,
            infos={"score": f(T, E), "episode_return": f(T, E),
                   "episode_length": rng.integers(0, 9, (T, E))
                   .astype(np.int32),
                   "valid": rng.random((T, E)) < 0.5},
            boot=f(R)))
    return out


def test_stack_fragments_matches_jax():
    frags = _frags(3)
    got, glast = al.stack_fragments([al.Fragment(**f) for f in frags])
    want, wlast = jal.stack_fragments([jal.Fragment(**f) for f in frags])
    for k in ("obs", "actions", "logprobs", "values", "rewards", "dones",
              "resets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in al.INFO_KEYS:
        np.testing.assert_array_equal(got.infos[k], want.infos[k])
    np.testing.assert_array_equal(glast, wlast)
    assert got.obs.shape == (3, 6, 4)


def test_staleness_drop_filter():
    """Drop mode discards fragments older than max_staleness learner
    versions and keeps pulling until the batch is full."""
    frags = [SimpleNamespace(version=v) for v in (2, 5, 3, 4)]

    class FakeRollouts:
        def wait_fragments(self, n, *, timeout):
            assert timeout > 0
            return [frags.pop(0) for _ in range(min(n, len(frags)))]

    fake = SimpleNamespace(
        tcfg=TrainConfig(max_staleness=1, staleness_mode="drop"),
        rollouts=FakeRollouts(), _version=5, _dropped=0)
    out = TrainEngine._collect_fragments(fake, 2)
    assert [f.version for f in out] == [5, 4]    # ages 0 and 1 survive
    assert fake._dropped == 2                    # ages 3 and 2 dropped


@pytest.mark.parametrize("on_policy", [False, True])
@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_adv_matches_jax(on_policy, rho_bar, c_bar):
    obs_dim, nvec, T, B = 6, (3, 2), 7, 5
    jp = jpolicy.OceanPolicy(obs_dim, nvec, hidden=16)
    tp = tpolicy.OceanPolicy(obs_dim, nvec, hidden=16)
    params = jp.init(jax.random.PRNGKey(1))
    tparams = ocean_params_from_jax(jax.tree.map(np.asarray, params))
    jdist, tdist = jD.Dist("categorical", nvec), tD.Dist("categorical", nvec)
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((T, B, obs_dim)).astype(np.float32)
    actions = np.stack([rng.integers(0, n, (T, B)) for n in nvec],
                       -1).astype(np.int32)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.2
    last_value = rng.standard_normal(B).astype(np.float32)
    if on_policy:
        logits, _, _ = jp.seq(params, jnp.asarray(obs), None,
                              jnp.zeros((T, B), bool))
        logp = np.asarray(jdist.log_prob(logits, jnp.asarray(actions)))
    else:
        logp = (0.3 * rng.standard_normal((T, B))).astype(np.float32)
    jtraj = JTrajectory(obs=obs, actions=actions, logprobs=logp,
                        values=np.zeros((T, B), np.float32), rewards=rewards,
                        dones=dones, resets=np.zeros((T, B), bool), infos={})
    ttraj = Trajectory(*(torch.from_numpy(np.array(x)) for x in jtraj[:7]),
                       infos={})
    jcfg, tcfg = JTrainConfig(gamma=0.9), TrainConfig(gamma=0.9)
    jadv, jvs = jlearner.make_vtrace_adv(jp, jdist, jcfg, rho_bar, c_bar)(
        params, jtraj, last_value)
    tadv, tvs = make_vtrace_adv(tp, tdist, tcfg, rho_bar, c_bar)(
        tparams, ttraj, torch.from_numpy(last_value))
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **TOL)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), **TOL)


def test_vtrace_refuses_recurrent_policies():
    pol = tpolicy.OceanPolicy(6, (3,), hidden=8, recurrent=True)
    with pytest.raises(ValueError, match="non-recurrent"):
        make_vtrace_adv(pol, tD.Dist("categorical", (3,)), TrainConfig())


def test_actor_refuses_a_forked_cuda_child(monkeypatch):
    monkeypatch.setattr(torch.cuda, "_is_in_bad_fork", lambda: True)
    cfg = al.ActorConfig(shm_name="unused", actor_id=0, spec=_spec(),
                         seed=0)
    with pytest.raises(RuntimeError, match="spawn"):
        al.actor_main(cfg)


def test_actor_chain_imports_no_torch():
    """The spawn entrypoint's import chain stays torch-free (actors import
    torch after the fork guard), as do checkpoints and telemetry."""
    code = ("import sys\n"
            "import repro_torch.distributed.actor_learner\n"
            "import repro_torch.distributed.fault\n"
            "import repro_torch.checkpoint.ckpt\n"
            "import repro_torch.telemetry.traceprop\n"
            "import repro_torch.utils.metrics\n"
            "assert 'torch' not in sys.modules\n"
            "assert not any(m == 'jax' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr


# ------------------------------- telemetry ------------------------------------

def test_spans_nest_and_export_a_chrome_trace(tmp_path):
    assert telemetry.span("x") is telemetry.span("y")   # disabled: no-op
    telemetry.enable(str(tmp_path))
    try:
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                pass
        recs = telemetry.get_tracer().records()
        assert [(r.name, r.depth, r.parent) for r in recs] == [
            ("inner", 1, "outer"), ("outer", 0, "")]
        trace = telemetry.chrome_trace(recs)
        assert {e["name"] for e in trace["traceEvents"]} == {"inner",
                                                            "outer"}
        assert telemetry.flush() == 2
        assert traceprop.current().run_dir == str(tmp_path)
    finally:
        telemetry.disable()
    merged = traceprop.merge_chrome_trace(str(tmp_path))
    assert merged["otherData"]["processes"] == 1
    assert sum(e["ph"] == "X" for e in merged["traceEvents"]) == 2


def test_registry_counts_and_exports():
    reg = telemetry.Registry()
    reg.counter("engine.updates", tier="async").inc(3)
    h = reg.histogram("async.frag_age", edges=(0.0, 1.0, 2.0))
    for a in (0, 1, 1, 5):
        h.observe(a)
    flat = reg.flat()
    assert flat["engine.updates{tier=async}"] == 3
    assert flat["async.frag_age_count"] == 4
    assert h.counts == [0, 1, 2, 1]          # bisect_right over the edges
    assert h.quantile(0.5) == 2.0
    text = reg.to_prometheus()
    assert 'engine_updates{tier="async"} 3.0' in text
    assert 'async_frag_age_bucket{le="+Inf"} 4' in text


def test_tier_timer_resume_aware_sps_and_spans(tmp_path):
    t = TierTimer(100, done_before_steps=1000)
    time.sleep(0.01)
    md = t.stamp({}, 1100)
    assert md["env_steps"] == 1100 and 0 < md["sps"] < 100 / 0.01 + 1
    telemetry.enable()
    try:
        t2 = TierTimer(10)
        with t2.launch():
            pass
        names = [r.name for r in telemetry.get_tracer().records()]
        assert names == ["engine.launch"] and t2.launch_ms >= 0.0
    finally:
        telemetry.disable()


def test_actor_stat_rows_and_staleness_histogram():
    slab = StatSlab.create(2, ACTOR_FIELDS, STALENESS_EDGES)
    try:
        row = slab.row(1)
        row.add("steps", 64)
        for age in (0, 1, 3, 9):
            row.observe(age)
        agg = slab.aggregate()
        assert agg["total"]["steps"] == 64
        assert agg["hist"]["counts"] == [1, 1, 0, 1, 0, 1]
        del row
    finally:
        slab.close()


# --------------------------- integration layer --------------------------------

def _async_engine(tmpdir=None, seed=0, **overrides):
    em, dist, policy = ocean_policy_stack(ocean.Bandit(), hidden=32)
    kw = dict(num_envs=8, unroll_length=8, num_actors=2, checkpoint_every=0,
              async_recv_timeout=60.0)
    kw.update(overrides)
    return TrainEngine(em, policy, ocean_tcfg("bandit", **kw), dist,
                       seed=seed, device="cpu", backend="async",
                       checkpoint_dir=str(tmpdir) if tmpdir else None)


def test_async_config_validation():
    with pytest.raises(ValueError, match="num_shards"):
        _async_engine(num_actors=3)              # 8 envs % 3 shards != 0
    with pytest.raises(ValueError, match="staleness_mode"):
        _async_engine(staleness_mode="nope")
    em, dist, policy = ocean_policy_stack(ocean.Bandit(), hidden=8,
                                          recurrent=True)
    with pytest.raises(ValueError, match="recurrent"):
        TrainEngine(em, policy, ocean_tcfg("bandit", num_envs=8),
                    dist, device="cpu", backend="async")
    with pytest.raises(ValueError, match="updates_per_launch"):
        TrainEngine(em, policy, ocean_tcfg("bandit", num_envs=8), dist,
                    device="cpu", backend="async", updates_per_launch=2)


def test_async_tier_runs_accounts_and_traces_every_process(tmp_path):
    """4 updates: the history keys, the stats, and one Chrome trace in
    which the learner and both actors have their own lanes."""
    run_dir = str(tmp_path / "run")
    telemetry.enable(run_dir)
    spu = 8 * 8
    eng = _async_engine()
    try:
        hist, solved = eng.run(total_steps=spu * 4)
        st = eng.stats()["rollouts"]
    finally:
        eng.close()                  # actors flush their spans on exit
        telemetry.flush()
        telemetry.disable()
    assert len(hist) == 4 and hist[-1]["env_steps"] == 4 * spu
    for k in ("frag_age_mean", "frag_age_max", "dropped_fragments",
              "stragglers", "actors_alive", "reshards", "sps"):
        assert k in hist[-1], k
    assert hist[-1]["actors_alive"] == 2 and hist[-1]["reshards"] == 0
    assert st["devices"] == ["cpu", "cpu"] and st["dead"] == []
    assert st["actors"]["total"]["fragments"] >= 4 * 2
    assert len(eng.collect_waits) == 4
    assert 0.0 < eng.first_batch_s and sum(eng.collect_waits) <= eng.run_s
    trace = traceprop.merge_chrome_trace(run_dir)
    roles = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M"}
    assert {"main", "actor-0", "actor-1"} <= roles
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"async.wait_fragments", "actor.rollout",
            "engine.launch"} <= names


def test_async_tier_trains_bandit_two_actors():
    """The async tier trains: bandit to >= 0.9 with 2 actors (16 envs x 16
    steps an update; it solves in about 30 updates)."""
    eng = _async_engine(num_envs=16, unroll_length=16)
    try:
        hist, solved = eng.run(total_steps=150_000, target_score=0.9)
    finally:
        eng.close()
    assert solved is not None, (
        f"async tier failed to train bandit: best score "
        f"{max(m['score'] for m in hist):.3f} over {len(hist)} updates")


def test_async_kill_actor_reshards_without_hang():
    """Killing one actor mid-run reassigns its shard to the survivor and
    the run completes. The kill is waited for (join), so the learner's
    next wait_fragments sees a dead process: no timing assumption."""
    eng = _async_engine()
    spu = 8 * 8
    killed = {}

    def on_update(u, md):
        if u == 1:
            p = eng.rollouts._procs[1]
            p.kill()
            p.join(timeout=30)
            killed["dead"] = not p.is_alive()

    try:
        hist, _ = eng.run(total_steps=spu * 6, on_update=on_update)
        st = eng.rollouts.stats()
    finally:
        eng.close()
    assert killed["dead"]
    assert len(hist) == 6                        # no updates lost
    assert len(eng.rollouts.events) == 1
    ev = eng.rollouts.events[0]
    assert ev.actor == 1 and ev.shards == (1,) and ev.new_owners == (0,)
    assert st["assign"] == [0, 0] and st["dead"] == [1]
    assert st["epoch"] == [0, 1]                 # the new owner re-seeds
    assert hist[-1]["actors_alive"] == 1 and hist[-1]["reshards"] == 1


def test_async_kill_then_resume_step_count(tmp_path):
    """A learner killed mid-run resumes from its checkpoint and ends at
    the same update count as an uninterrupted run."""
    spu = 8 * 8

    class Kill(BaseException):                   # not caught by the loop
        pass

    def on_update(u, md):
        if u >= 2:                               # 3 updates done, ckpt at 2
            raise Kill

    eng = _async_engine(tmp_path, checkpoint_every=2)
    try:
        with pytest.raises(Kill):
            eng.run(total_steps=spu * 6, on_update=on_update)
    finally:
        eng.close()
    assert ckpt.step_of(ckpt.latest(str(tmp_path))) == 2

    eng2 = _async_engine(tmp_path, seed=7, checkpoint_every=2)
    try:
        assert eng2.restore() == 2
        saved = ckpt.restore(str(tmp_path / "step_2"), eng2._ckpt_like())
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(eng2.ts.params), tree_leaves(saved["ts"][0])))
        hist, _ = eng2.run(total_steps=spu * 6)
    finally:
        eng2.close()
    assert len(hist) == 4                        # updates 3..6 only
    assert hist[-1]["env_steps"] == 6 * spu
    assert ckpt.step_of(ckpt.latest(str(tmp_path))) == 6


def test_launcher_runs_the_async_tier():
    """``--engine-backend async`` through the launcher prints the update
    count, the launches and one line per actor with its device."""
    from repro_torch.launch import train as train_cli
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = train_cli.main(["--ocean", "bandit", "--device", "cpu",
                              "--engine-backend", "async", "--num-actors",
                              "2", "--num-envs", "8",
                              "--total-env-steps", str(3 * 8 * 64),
                              "--full-budget"])
    text = out.getvalue()
    assert res["bandit"]["env_steps"] == 3 * 8 * 64
    assert "updates=3 last_update=3" in text
    assert "actor 0: device=cpu" in text and "actor 1: device=cpu" in text
    assert "learner_idle=" in text
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            train_cli.main(["--ocean", "bandit", "--device", "cpu",
                            "--num-actors", "2"])
