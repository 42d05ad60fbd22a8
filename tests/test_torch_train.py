"""The port's Ocean PPO training path on the CPU: the engine's launches and
accounting, the Trainer solving the preset envs, and the launcher.

The counterparts of tests/test_engine.py (fused vs sequential, accounting)
and of the JAX Trainer smokes; on the CPU GAE takes its plain version.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bridge import wrap
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.ocean import ocean_tcfg, preset
from repro_torch.envs import ocean
from repro_torch.envs.ocean_host import HostBandit
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import tree_leaves
from repro_torch.rl.engine import METRIC_KEYS, TrainEngine
from repro_torch.rl.trainer import Trainer, ocean_policy_stack

ROOT = Path(__file__).resolve().parent.parent
TCFG = TrainConfig(num_envs=16, unroll_length=16, update_epochs=2,
                   num_minibatches=2, learning_rate=1e-3, gamma=0.95)


def _engine(env, K=1, recurrent=False, tcfg=TCFG):
    em, dist, pol = ocean_policy_stack(env, hidden=32, recurrent=recurrent)
    return TrainEngine(em, pol, tcfg, dist, seed=0, device="cpu",
                       updates_per_launch=K)


@pytest.mark.parametrize("name,recurrent", [("bandit", False),
                                            ("memory", True)])
def test_fused_launch_equals_sequential_launches(name, recurrent):
    """K = 4 in one launch == 4 launches of K = 1 from the same generator
    state: identical params and identical metric rows."""
    fused = _engine(ocean.OCEAN[name](), 4, recurrent)
    seq = _engine(ocean.OCEAN[name](), 1, recurrent)
    ring = fused.launch(4)
    rows = torch.cat([seq.launch(1) for _ in range(4)])
    assert ring.shape == (4, len(METRIC_KEYS))
    assert torch.equal(ring, rows)
    for a, b in zip(tree_leaves(fused.ts.params), tree_leaves(seq.ts.params)):
        assert torch.equal(a, b)
    assert int(fused.ts.step) == 4 * TCFG.update_epochs * TCFG.num_minibatches
    if recurrent:
        c, h = fused.rc.policy_carry
        assert c.shape == (TCFG.num_envs, 32)
        assert bool(torch.isfinite(h).all())


def test_partial_tail_launch_and_accounting():
    """num_updates not divisible by K: the tail launch is shorter and the
    history covers exactly total_steps // steps_per_update rows."""
    e = _engine(ocean.Bandit(), 4)
    launched = []
    hist, solved = e.run(6 * e.steps_per_update + 5,
                         on_launch=launched.append)
    assert solved is None and len(hist) == 6
    assert e.steps_per_update == TCFG.unroll_length * TCFG.num_envs
    assert [h["env_steps"] for h in hist] == \
        [(i + 1) * e.steps_per_update for i in range(6)]
    assert launched == [4, 6]
    for h in hist:
        assert set(METRIC_KEYS) <= set(h)
        assert h["sps"] > 0 and h["launch_ms"] > 0
    # multiagent: a step is N·A transitions
    m = _engine(ocean.Multiagent(), 1)
    assert m.steps_per_update == TCFG.unroll_length * TCFG.num_envs * 2


def test_target_score_stops_at_a_launch_boundary():
    e = _engine(ocean.Bandit(), 4)
    hist, solved = e.run(400 * e.steps_per_update, target_score=0.5)
    assert solved is not None and solved["score"] >= 0.5
    assert len(hist) < 400 and len(hist) % 4 == 0


@pytest.mark.parametrize("name", list(ocean.OCEAN))
def test_every_env_trains_one_update(name):
    p = preset(name)
    tcfg = ocean_tcfg(name, num_envs=8, unroll_length=8)
    tr = Trainer(ocean.OCEAN[name](), tcfg, hidden=16, recurrent=p.recurrent,
                 device="cpu")
    m = tr.train(tr.steps_per_update)
    assert len(tr.history) == 1
    assert all(math.isfinite(m[k]) for k in METRIC_KEYS)


def test_unported_backends_and_checkpoints_raise(tmp_path):
    em, dist, pol = ocean_policy_stack(ocean.Bandit(), hidden=8)
    with pytest.raises(ValueError, match="slice"):
        TrainEngine(em, pol, TCFG, dist, device="cpu", backend="shard_map")
    # the async tier is ported: its config is checked before any actor
    # spawns (16 envs do not split into 3 shards)
    with pytest.raises(ValueError, match="num_shards"):
        TrainEngine(em, pol, dataclasses.replace(TCFG, num_actors=3), dist,
                    device="cpu", backend="async")
    # the pool tier takes the batched env; the host tier a HostVecEnv only
    assert TrainEngine(em, pol, TCFG, dist, device="cpu",
                       backend="pool").pool.num_buffers == 2
    with pytest.raises(ValueError, match="HostVecEnv"):
        TrainEngine(em, pol, TCFG, dist, device="cpu", backend="host")
    hv = wrap(HostBandit, num_envs=TCFG.num_envs)
    try:
        eng = TrainEngine(hv, pol, TCFG, dist, device="cpu", backend="host")
        assert eng.hvec is hv
    finally:
        hv.close()
    # checkpoints and the metrics log are ported: save writes a committed
    # checkpoint and log_dir opens the run's JSONL stream
    tr = Trainer(ocean.Bandit(), TCFG, hidden=8, device="cpu")
    assert tr.save(str(tmp_path / "ck")).endswith("step_0")
    lg = Trainer(ocean.Bandit(), TCFG, log_dir=str(tmp_path / "log"),
                 device="cpu").logger
    assert lg.path.endswith("bandit.jsonl")
    lg.close()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bandit", "squared"])
def test_trainer_solves_at_the_preset(name):
    """The preset (64 envs × 64 steps, hidden 64, seed 0) reaches score
    ≥ 0.9 within its step budget (bandit 150k, squared 300k)."""
    p = preset(name)
    tr = Trainer(ocean.OCEAN[name](), ocean_tcfg(name), hidden=p.hidden,
                 recurrent=p.recurrent, seed=0, device="cpu")
    m = tr.train(p.total_steps, target_score=p.target_score)
    assert m["score"] >= p.target_score, m
    assert m["env_steps"] <= p.total_steps


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--ocean",
         "bandit", "--device", "cpu", "--total-env-steps", "16384"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "score=" in r.stdout and "steps=16384" in r.stdout


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--ocean", "bandit"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(ocean.Bandit(), TCFG)
