"""TrainEngine: K PPO updates per launch, one metrics fetch per launch.

The counterpart of the ``jit`` tier of ``repro/rl/engine.py``. There a
launch is one compiled ``scan`` over K fused updates; here it is K updates
enqueued eagerly on the device, none of which syncs with the host: the
metrics of each update are packed into one row of a ``(K, 10)`` device
tensor, which is copied to the host once per launch, asynchronously. The
engine fetches it one launch late (so the host enqueues launch i+1 while
the device runs launch i), or at once when ``target_score`` is set, which
is checked at launch boundaries.

The other tiers (``shard_map``, ``pool``, ``host``, ``async``), self-play
and checkpoints come with later slices.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import TrainConfig
from repro_torch.core.vector import VecEnv
from repro_torch.rl.learner import init_train_state, make_ocean_update
from repro_torch.rl.rollout import RolloutCarry
from repro_torch.telemetry import TierTimer

METRIC_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
               "clipfrac", "grad_norm", "score", "episode_return", "episodes")

_LATER = {"shard_map": "the data-parallel slice",
          "pool": "the host-tier slice", "host": "the host-tier slice",
          "async": "the host-tier slice (async actor-learner)"}


def pack_metrics(m: dict) -> torch.Tensor:
    """Metrics dict of 0-dim device tensors → one f32 row."""
    return torch.stack([m[k].float().reshape(()) for k in METRIC_KEYS])


def unpack_metrics(row) -> dict:
    return {k: float(v) for k, v in zip(METRIC_KEYS, row)}


class TrainEngine:
    """Owns the device-resident training state and runs the launches.

    ``env`` is a (usually ``Emulated``) batched env, ``policy`` an
    OceanPolicy, ``dist`` a distributions.Dist. One generator on ``device``,
    seeded with ``seed``, draws the parameters, the env states and then
    every update's randomness in order, so K updates in one launch equal K
    launches of one update. ``device=None`` means CUDA (raises without a
    Hopper card)."""

    def __init__(self, env, policy, tcfg: TrainConfig, dist, *,
                 seed: int = 0, device=None, backend: str = None,
                 updates_per_launch: int = None):
        self.env, self.policy, self.tcfg, self.dist = env, policy, tcfg, dist
        self.backend = backend or tcfg.engine_backend
        if self.backend in _LATER:
            raise ValueError(f"engine backend {self.backend!r} comes with "
                             f"{_LATER[self.backend]}; the port runs 'jit'")
        if self.backend != "jit":
            raise ValueError(f"unknown engine backend {self.backend!r}; "
                             f"the port runs 'jit'")
        self.K = updates_per_launch or tcfg.updates_per_launch
        if self.K < 1:
            raise ValueError(f"updates_per_launch must be >= 1, got {self.K}")
        self.device = _device.resolve(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ts = init_train_state(policy.init(self.generator))
        self.vec = VecEnv(env, tcfg.num_envs)
        env_state, obs = self.vec.init(self.generator)
        B = self.vec.batch_size
        self.rc = RolloutCarry(
            env_state, obs, policy.initial_carry(B, self.device),
            torch.zeros(B, dtype=torch.bool, device=self.device))
        self.update = make_ocean_update(policy, self.vec.step, tcfg, dist)

    @property
    def steps_per_update(self) -> int:
        return self.tcfg.unroll_length * self.vec.batch_size

    def launch(self, k: int) -> torch.Tensor:
        """Enqueue ``k`` updates; returns their (k, 10) metrics on the
        device. No host sync."""
        rows = []
        for _ in range(k):
            self.ts, self.rc, m = self.update(self.ts, self.rc,
                                              self.generator)
            rows.append(pack_metrics(m))
        return torch.stack(rows)

    def _to_host(self, ring: torch.Tensor):
        """Start the ring's copy to the host; returns (host tensor, event
        to wait on, or None on the CPU)."""
        if ring.device.type != "cuda":
            return ring, None
        host = ring.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def run(self, total_steps: int, *, target_score: Optional[float] = None,
            on_update: Optional[Callable] = None,
            on_launch: Optional[Callable] = None):
        """Train until env interactions ≥ total_steps (or solved).

        Returns ``(history, solved)``: per-update metric dicts with the
        ``env_steps``/``sps``/``launch_ms``/``fetch_ms`` keys.
        ``on_update(u, metrics)`` fires per update once its launch's metrics
        are fetched; ``on_launch(updates_dispatched)`` right after each
        launch is enqueued."""
        spu = self.steps_per_update
        num_updates = max(1, total_steps // spu)
        history, pending, solved = [], deque(), None
        timer = TierTimer(spu)

        def drain_one():
            nonlocal solved
            u0, kk, host, done = pending.popleft()
            with timer.fetch():
                if done is not None:
                    done.synchronize()
                rows = host.tolist()
            for i in range(kk):
                md = unpack_metrics(rows[i])
                timer.stamp(md, (u0 + i + 1) * spu)
                history.append(md)
                if on_update is not None:
                    on_update(u0 + i, md)
                if (target_score is not None and solved is None
                        and md["episodes"] > 0
                        and md["score"] >= target_score):
                    solved = md

        u = 0
        while u < num_updates:
            k = min(self.K, num_updates - u)
            with timer.launch():
                host, done = self._to_host(self.launch(k))
            pending.append((u, k, host, done))
            u += k
            if on_launch is not None:
                on_launch(u)
            if target_score is not None:
                while pending:
                    drain_one()
                if solved is not None:
                    break
            elif len(pending) > 1:
                drain_one()
        while pending:
            drain_one()
        return history, solved
