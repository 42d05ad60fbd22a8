"""The port's checkpoints and metrics log on the CPU: ``checkpoint/ckpt.py``
(round trip with bf16, ``latest``/``keep``, async save, no partial commit),
``distributed/fault.py`` (ResilientLoop recovery, gap rewind, live-stream
retry, poison pill; the straggler monitor), checkpoints that cross between
the two packages, the engine's checkpoints on the jit, pool and host tiers
(a stopped-and-resumed jit run is bitwise equal to an uninterrupted one),
``Trainer.save``/``restore``/``log_dir`` and the launcher's ``--ckpt-dir
--resume``.

The counterparts of tests/test_checkpoint.py and the checkpoint tests of
tests/test_engine.py; cross-package checkpoints are saved by one package's
``ckpt.save`` and restored by the other's ``ckpt.restore`` live.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.models import policy as jpolicy
from repro_torch.bridge import wrap
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.fault import (ResilientLoop, StragglerMonitor,
                                           _true_median)
from repro_torch.envs import ocean
from repro_torch.envs.ocean_host import HostBandit
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import ocean_params_from_jax
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl.engine import TrainEngine
from repro_torch.rl.trainer import Trainer, ocean_policy_stack
from repro_torch.utils import metrics as tmetrics

CKPT_TCFG = TrainConfig(num_envs=16, unroll_length=16, update_epochs=2,
                        num_minibatches=2, learning_rate=1e-3, gamma=0.95,
                        checkpoint_every=3)


class Pair(NamedTuple):
    a: torch.Tensor
    b: object


def _tree():
    return {"params": {"w": torch.arange(24.0).reshape(4, 6),
                       "b": torch.ones(6, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32),
            "pair": Pair(torch.zeros(3, dtype=torch.bool), None),
            "seq": (torch.tensor([1.5]), np.arange(3, dtype=np.int64))}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(_zeros_like(tree.a), None)
    if isinstance(tree, tuple):
        return tuple(_zeros_like(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return torch.zeros_like(tree)


def _assert_tree_equal(a, b):
    la = [leaf for _, leaf in ckpt._flatten_with_names(a)]
    lb = [leaf for _, leaf in ckpt._flatten_with_names(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)


# -- checkpoint/ckpt.py ---------------------------------------------------------

def test_roundtrip_dicts_namedtuples_tuples_and_numpy(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), t, step=3)
    assert path.endswith("step_3")
    r = ckpt.restore(str(tmp_path), _zeros_like(t))
    _assert_tree_equal(r, t)
    assert isinstance(r["pair"], Pair) and r["pair"].b is None
    assert isinstance(r["seq"][1], np.ndarray)
    # the reference's layout: one .npy per array, index.json with shapes,
    # dtypes and each shard's slice, names by key path
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    assert index["step"] == 3
    assert sorted(index["arrays"]) == ["pair/a", "params/b", "params/w",
                                       "seq/0", "seq/1", "step"]
    w = index["arrays"]["params/w"]
    assert w["shape"] == [4, 6] and w["dtype"] == "float32"
    assert w["shards"] == [{"file": "params.w.full.npy",
                            "slice": [[0, 4], [0, 6]]}]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int8, torch.uint8, torch.bool,
                                   torch.int64])
@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_dtype_roundtrip_bit_exact(tmp_path, dtype, shape):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 100).to(dtype)
    ckpt.save(str(tmp_path), {"x": x}, step=0)
    r = ckpt.restore(str(tmp_path), {"x": torch.empty(shape, dtype=dtype)})
    assert r["x"].dtype == dtype and r["x"].shape == x.shape
    assert torch.equal(r["x"].view(-1).view(torch.uint8)
                       if dtype != torch.bool else r["x"],
                       x.view(-1).view(torch.uint8)
                       if dtype != torch.bool else x)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), t, step=s, keep=2)
    assert ckpt.latest(str(tmp_path)).endswith("step_5")
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    for s in range(6, 8):
        ckpt.save(str(tmp_path), t, step=s, keep=None)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5", "step_6",
                                           "step_7"]


def test_async_save_writes_the_values_at_the_call(tmp_path):
    """The host copy is made before the writer thread starts: a tensor
    changed in place after the call does not reach the file."""
    x = torch.arange(1000.0)
    h = ckpt.save(str(tmp_path), {"x": x}, step=1, async_=True)
    x.add_(1.0)                                # the live tensor moves on
    h.join()
    assert ckpt.latest(str(tmp_path)).endswith("step_1")
    r = ckpt.restore(str(tmp_path), {"x": torch.empty(1000)})
    assert torch.equal(r["x"], torch.arange(1000.0))


def test_no_partial_commit(tmp_path):
    """A .tmp dir is never picked up as a checkpoint."""
    os.makedirs(tmp_path / "step_9.tmp")
    assert ckpt.latest(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _tree())
    ckpt.save(str(tmp_path), _tree(), step=2)
    assert ckpt.latest(str(tmp_path)).endswith("step_2")


def test_restore_checks_names_and_shapes(tmp_path):
    ckpt.save(str(tmp_path), {"x": torch.zeros(3)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(4)})
    with pytest.raises(KeyError, match="y"):
        ckpt.restore(str(tmp_path), {"y": torch.zeros(3)})


def test_step_of_reads_metadata_not_the_path(tmp_path):
    d = tmp_path / "run_v2_final"
    ckpt.save(str(d), _tree(), step=12)
    dst = tmp_path / "best_model_final"
    os.rename(ckpt.latest(str(d)), dst)
    assert ckpt.step_of(str(dst)) == 12
    state, step = ResilientLoop(lambda s, b: (s, {}),
                                str(dst)).resume_or_init(
        _zeros_like(_tree()))
    assert step == 12
    _assert_tree_equal(state, _tree())


# -- cross-package checkpoints ---------------------------------------------------

def _ocean_params(recurrent):
    jp = jpolicy.OceanPolicy(12, (3, 2), hidden=16, recurrent=recurrent)
    params = jp.init(jax.random.PRNGKey(3))
    params = jax.tree.map(lambda x: x + 0.1 * jnp.cos(
        jnp.arange(x.size, dtype=jnp.float32).reshape(x.shape)), params)
    return params, ocean_params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("recurrent", [False, True])
def test_jax_saved_ocean_params_restore_in_the_port(tmp_path, recurrent):
    jparams, tparams = _ocean_params(recurrent)
    jckpt.save(str(tmp_path), {"params": jparams}, step=4)
    like = {"params": jax.tree.map(torch.zeros_like, tparams)}
    r = ckpt.restore(str(tmp_path), like)
    assert ckpt.step_of(ckpt.latest(str(tmp_path))) == 4
    for name, leaf in ckpt._flatten_with_names(r):
        want = tparams
        for k in name.split("/")[1:]:
            want = want[k]
        assert torch.equal(leaf, want), name


@pytest.mark.parametrize("recurrent", [False, True])
def test_port_saved_ocean_params_restore_in_jax(tmp_path, recurrent):
    jparams, tparams = _ocean_params(recurrent)
    ckpt.save(str(tmp_path), {"params": tparams}, step=5)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jparams})
    r = jckpt.restore(str(tmp_path), like)
    for x, y in zip(jax.tree.leaves(r), jax.tree.leaves({"params": jparams})):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_bf16_crosses_both_ways(tmp_path):
    """bf16 leaves go as raw bytes under the name "bfloat16", as the
    reference stores its custom dtypes: both directions are bit exact."""
    jx = jnp.arange(-6, 6, dtype=jnp.float32).reshape(3, 4) / 3
    jx = jx.astype(jnp.bfloat16)
    jckpt.save(str(tmp_path / "j"), {"w": jx, "s": jnp.asarray(3)}, step=0)
    r = ckpt.restore(str(tmp_path / "j"),
                     {"w": torch.empty(3, 4, dtype=torch.bfloat16),
                      "s": torch.zeros((), dtype=torch.int32)})
    want = np.asarray(jx).view(np.uint16)
    np.testing.assert_array_equal(r["w"].view(torch.int16).numpy()
                                  .view(np.uint16), want)
    assert int(r["s"]) == 3

    ckpt.save(str(tmp_path / "t"), {"w": r["w"]}, step=0)
    back = jckpt.restore(str(tmp_path / "t"),
                         {"w": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.uint16),
                                  want)


# -- distributed/fault.py --------------------------------------------------------

def test_resilient_loop_recovers(tmp_path):
    """Inject a step failure; the loop restores and replays."""
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:            # fail once, mid-run
            raise RuntimeError("injected device failure")
        return {"x": state["x"] + batch}, {"loss": state["x"]}

    loop = ResilientLoop(step, str(tmp_path), save_every=1, async_save=False)
    out = loop.run({"x": torch.zeros(())}, [torch.ones(())] * 4)
    assert loop.recoveries == 1
    assert float(out["x"]) == 4.0      # all 4 batches applied exactly once
    assert loop.steps_done == 4


def test_resilient_loop_rewinds_past_checkpoint_gap(tmp_path):
    """With save_every > 1, a failure k steps past the last checkpoint
    restores AND rewinds, replaying batches S..S+k on the restored
    lineage."""
    calls = {"n": 0}
    applied = []

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 6:            # step 6 = 2 past the step-4 checkpoint
            raise RuntimeError("injected failure at S+2")
        return {"x": state["x"] + batch}, {"x_after": float(state["x"]) + 1}

    loop = ResilientLoop(step, str(tmp_path), save_every=2, async_save=False)
    out = loop.run({"x": torch.zeros(())}, [torch.ones(())] * 8,
                   on_metrics=lambda s, m: applied.append((s, m["x_after"])))
    assert loop.recoveries == 1
    assert float(out["x"]) == 8.0 and loop.steps_done == 8
    assert applied == [(s, float(s)) for s in [1, 2, 3, 4, 5, 5, 6, 7, 8]]


def test_resilient_loop_replayable_callable_source(tmp_path):
    calls = {"n": 0}
    starts = []

    def batches(start):
        starts.append(start)
        return (torch.ones(()) for _ in range(start, 6))

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("injected")
        return {"x": state["x"] + batch}, {}

    loop = ResilientLoop(step, str(tmp_path), save_every=3, async_save=False)
    out = loop.run({"x": torch.zeros(())}, batches)
    assert float(out["x"]) == 6.0 and loop.steps_done == 6
    assert starts == [0, 3]            # recovery re-invoked it at the ckpt


def test_resilient_loop_live_stream_retries_in_place(tmp_path):
    """A bare iterator cannot rewind: recovery retries the current batch
    and restores only a checkpoint sitting exactly at steps_done."""
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:            # fails on stream item 3, ckpt at 2
            raise RuntimeError("injected")
        return {"x": state["x"] + batch}, {}

    loop = ResilientLoop(step, str(tmp_path), save_every=2, async_save=False)
    out = loop.run({"x": torch.zeros(())}, iter([torch.ones(())] * 4))
    assert loop.recoveries == 1
    assert float(out["x"]) == 4.0 and loop.steps_done == 4


def test_resilient_loop_poison_pill_aborts(tmp_path):
    def step(state, batch):
        raise RuntimeError("always fails")

    loop = ResilientLoop(step, str(tmp_path), save_every=1, max_retries=2,
                         async_save=False)
    with pytest.raises(RuntimeError, match="poison pill"):
        loop.run({"x": torch.zeros(())}, [torch.ones(())] * 3)
    assert loop.recoveries == 3        # max_retries failures + the fatal one


def test_resilient_loop_async_save_joins_before_next(tmp_path, monkeypatch):
    from repro_torch.distributed import fault
    log = []

    class Handle:
        def __init__(self, step):
            self.step = step

        def join(self):
            log.append(("join", self.step))

    def fake_save(d, state, step, async_=False, keep=None):
        log.append(("save", step))
        assert async_
        return Handle(step)

    monkeypatch.setattr(fault.ckpt, "save", fake_save)
    loop = fault.ResilientLoop(lambda s, b: (s, {}), str(tmp_path),
                               save_every=1, async_save=True)
    loop.run({"x": torch.zeros(())}, [torch.ones(())] * 3)
    assert log == [("save", 1), ("join", 1), ("save", 2), ("join", 2),
                   ("save", 3), ("join", 3)]


def test_resume_or_init(tmp_path):
    t = _tree()
    loop = ResilientLoop(lambda s, b: (s, {}), str(tmp_path))
    state, step = loop.resume_or_init(_zeros_like(t))
    assert step == 0                   # nothing saved: the given state
    ckpt.save(str(tmp_path), t, step=11)
    state, step = loop.resume_or_init(_zeros_like(t))
    assert step == 11
    _assert_tree_equal(state, t)


def test_true_median_and_straggler_flagging():
    assert _true_median([]) == 0.0
    assert _true_median([3.0]) == 3.0
    assert _true_median([1.0, 1.0, 3.0, 3.0]) == 2.0
    mon = StragglerMonitor(window=8, k=2.0, min_samples=4)
    for dt in (1.0, 1.0, 3.0):
        assert not mon.record(dt)
    assert mon.record(4.2)             # window median 2.0 → threshold 4.0
    assert mon.flagged == 1 and mon.median == pytest.approx(2.0)
    st = mon.stats()
    assert st["samples"] == 4 and st["age_s"] >= 0.0


def test_straggler_flag_propagates_into_metrics():
    seen = []
    loop = ResilientLoop(lambda s, b: (s, {"loss": 0.0}), None, save_every=0)
    loop.monitor = StragglerMonitor(window=8, k=1e-9, min_samples=1)
    loop.run({"x": torch.zeros(())}, [torch.ones(())] * 2,
             on_metrics=lambda u, m: seen.append(m))
    assert all(m.get("straggler_flag") for m in seen[1:])


# -- the engine's checkpoints ------------------------------------------------------

def _engine(env, tcfg=CKPT_TCFG, seed=0, K=1, recurrent=False,
            backend="jit"):
    em, dist, pol = ocean_policy_stack(env, hidden=32, recurrent=recurrent)
    return TrainEngine(em, pol, tcfg, dist, seed=seed, device="cpu",
                       updates_per_launch=K, backend=backend)


def _assert_engines_equal(a, c):
    assert torch.equal(a.generator.get_state(), c.generator.get_state())
    for x, y in zip(tree_leaves(a.ts.params), tree_leaves(c.ts.params)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.ts.opt.m) + tree_leaves(a.ts.opt.v),
                    tree_leaves(c.ts.opt.m) + tree_leaves(c.ts.opt.v)):
        assert torch.equal(x, y)
    assert torch.equal(a.ts.step, c.ts.step)
    assert torch.equal(a.ts.opt.step, c.ts.opt.step)
    _assert_tree_equal(a.rc, c.rc)


@pytest.mark.parametrize("name,recurrent,K,stop", [
    ("bandit", False, 1, 3), ("memory", True, 2, 4),
    ("multiagent", False, 1, 3)])
def test_jit_stop_and_resume_is_bitwise_equal(tmp_path, name, recurrent, K,
                                              stop):
    """The checkpoint carries the TrainState, the generator's state and the
    rollout carry, so a resumed engine replays exactly the updates the
    uninterrupted one ran: params, optimizer state, generator and carry
    equal bit for bit."""
    a = _engine(ocean.OCEAN[name](), K=K, recurrent=recurrent)
    a.run(6 * a.steps_per_update)

    b = _engine(ocean.OCEAN[name](), K=K, recurrent=recurrent)
    b.checkpoint_dir = str(tmp_path)
    hist_b, _ = b.run(stop * b.steps_per_update)
    assert len(hist_b) == stop

    c = _engine(ocean.OCEAN[name](), seed=9, K=K, recurrent=recurrent)
    c.checkpoint_dir = str(tmp_path)
    assert c.restore() == stop
    hist_c, _ = c.run(6 * c.steps_per_update)
    assert len(hist_c) == 6 - stop              # only the remaining updates
    assert hist_c[0]["env_steps"] == (stop + 1) * c.steps_per_update
    _assert_engines_equal(a, c)


def test_async_save_of_a_live_engine_holds_the_values_at_the_call(tmp_path):
    e = _engine(ocean.Bandit())
    e.checkpoint_dir = str(tmp_path)
    e.run(2 * e.steps_per_update)
    snap = [x.clone() for x in tree_leaves(e.ts.params)]
    gen = e.generator.get_state()
    handle = e.save_checkpoint(2, async_=True)
    e._resume_update = 2
    e.run(4 * e.steps_per_update)               # the engine moves on
    handle.join()
    r = _engine(ocean.Bandit(), seed=3)
    r.checkpoint_dir = str(tmp_path)
    assert r.restore(str(tmp_path / "step_2")) == 2
    assert all(torch.equal(x, y)
               for x, y in zip(tree_leaves(r.ts.params), snap))
    assert torch.equal(r.generator.get_state(), gen)
    assert not all(torch.equal(x, y)
                   for x, y in zip(tree_leaves(e.ts.params), snap))


def test_checkpoint_cadence_and_gc(tmp_path):
    tcfg = dataclasses.replace(CKPT_TCFG, checkpoint_every=2,
                               keep_checkpoints=2)
    e = _engine(ocean.Bandit(), tcfg=tcfg)
    e.checkpoint_dir = str(tmp_path)
    e.run(7 * e.steps_per_update)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_6"]


def test_pool_tier_checkpoints_and_resumes(tmp_path):
    """The pool tier saves the learner and the generator (its env state
    is re-seeded) and a fresh engine resumes at the restored count."""
    e = _engine(ocean.Bandit(), backend="pool")
    e.checkpoint_dir = str(tmp_path)
    hist, _ = e.run(4 * e.steps_per_update)
    assert len(hist) == 4 and os.path.isdir(tmp_path / "step_3")
    e2 = _engine(ocean.Bandit(), backend="pool", seed=4)
    e2.checkpoint_dir = str(tmp_path)
    assert e2.restore() == 3
    saved = ckpt.restore(str(tmp_path / "step_3"), e2._ckpt_like())
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(e2.ts.params), tree_leaves(saved["ts"][0])))
    hist2, _ = e2.run(5 * e2.steps_per_update)
    assert len(hist2) == 2                      # updates 4 and 5
    assert hist2[0]["env_steps"] == 4 * e2.steps_per_update


def test_host_tier_checkpoints_and_resumes(tmp_path):
    tcfg = dataclasses.replace(CKPT_TCFG, num_envs=8, unroll_length=8,
                               checkpoint_every=2)
    em, dist, pol = ocean_policy_stack(ocean.Bandit(), hidden=16)
    engines = []
    try:
        for seed in (0, 1):
            hv = wrap(HostBandit, num_envs=2 * tcfg.num_envs,
                      batch_size=tcfg.num_envs, seed=seed)
            engines.append(TrainEngine(hv, pol, tcfg, dist, seed=seed,
                                       device="cpu", backend="host",
                                       checkpoint_dir=str(tmp_path)))
        e, e2 = engines
        hist, _ = e.run(3 * e.steps_per_update)
        assert len(hist) == 3 and ckpt.step_of(
            ckpt.latest(str(tmp_path))) == 2
        assert e2.restore() == 2
        hist2, _ = e2.run(4 * e2.steps_per_update)
        assert [h["env_steps"] for h in hist2] == \
            [3 * e2.steps_per_update, 4 * e2.steps_per_update]
    finally:
        for e in engines:
            e.close()


# -- Trainer and the launcher ------------------------------------------------------

def test_trainer_save_restore_roundtrip(tmp_path):
    tr = Trainer(ocean.Bandit(), CKPT_TCFG, hidden=16, device="cpu")
    tr.train(2 * tr.steps_per_update)
    tr.save(str(tmp_path))
    tr2 = Trainer(ocean.Bandit(), CKPT_TCFG, hidden=16, seed=5, device="cpu")
    tr2.restore(str(tmp_path))
    for x, y in zip(tree_leaves(tr.ts.params) + tree_leaves(tr.ts.opt.m),
                    tree_leaves(tr2.ts.params) + tree_leaves(tr2.ts.opt.m)):
        assert torch.equal(x, y)
    assert int(tr2.ts.step) == int(tr.ts.step)


def test_trainer_resume_flag_and_metrics_log(tmp_path):
    """train(checkpoint_dir=, resume=True) restores the newest engine
    checkpoint and continues the count; log_dir streams one record per
    update into <log_dir>/bandit.jsonl."""
    log_dir = str(tmp_path / "log")
    tr = Trainer(ocean.Bandit(), CKPT_TCFG, hidden=32, device="cpu",
                 log_dir=log_dir)
    tr.train(3 * tr.steps_per_update, checkpoint_dir=str(tmp_path / "ck"))
    tr.logger.close()
    tr2 = Trainer(ocean.Bandit(), CKPT_TCFG, hidden=32, device="cpu",
                  log_dir=log_dir)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        m = tr2.train(6 * tr2.steps_per_update,
                      checkpoint_dir=str(tmp_path / "ck"), resume=True)
    tr2.logger.close()
    tr2.logger.close()                          # idempotent
    assert "resumed at update 3" in out.getvalue()
    assert len(tr2.history) == 3                # updates 4..6 only
    assert m["env_steps"] == 6 * tr2.steps_per_update
    recs = tmetrics.read(os.path.join(log_dir, "bandit.jsonl"))
    assert [r["step"] for r in recs] == \
        [(i + 1) * tr.steps_per_update for i in range(6)]
    assert all(math.isfinite(r["loss"]) for r in recs)


def test_metrics_logger_scrubs_non_finite(tmp_path):
    with tmetrics.MetricsLogger(str(tmp_path), "run") as ml:
        ml.log(1, {"a": float("nan"), "b": 2.0, "c": "text"})
        ml.log_batch([{"env_steps": 5, "a": float("inf")}])
    recs = tmetrics.read(str(tmp_path / "run.jsonl"))
    assert recs[0]["a"] is None and recs[0]["b"] == 2.0 and "c" not in recs[0]
    assert recs[1]["step"] == 5 and recs[1]["a"] is None
    assert tmetrics.MetricsLogger(None).path is None


def test_launcher_ckpt_dir_and_resume(tmp_path):
    """--ckpt-dir saves under <dir>/<env> every --save-every updates and
    --resume continues to the same final count as one run would."""
    base = ["--ocean", "bandit", "--device", "cpu", "--num-envs", "16",
            "--full-budget", "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    spu = 16 * 64
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(base + ["--total-env-steps", str(3 * spu)])
    assert ckpt.step_of(ckpt.latest(str(tmp_path / "bandit"))) == 2
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = train_cli.main(base + ["--total-env-steps", str(5 * spu),
                                     "--resume"])
    assert "resumed at update 2" in out.getvalue()
    assert res["bandit"]["env_steps"] == 5 * spu
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            train_cli.main(["--ocean", "bandit", "--device", "cpu",
                            "--resume"])
