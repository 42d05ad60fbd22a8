"""TrainEngine: the PPO training loop behind one ``run(total_steps)``.

The counterpart of ``repro/rl/engine.py``'s ``jit``, ``pool`` and ``host``
tiers:

  * ``jit``  — a launch is K updates enqueued eagerly on the device, none of
               which syncs with the host: the metrics of each update are
               packed into one row of a ``(K, 10)`` device tensor, copied to
               the host once per launch, asynchronously. The engine fetches
               it one launch late (so the host enqueues launch i+1 while the
               device runs launch i), or at once when ``target_score`` is
               set, which is checked at launch boundaries.
  * ``pool`` — the double-buffered pool (``core/pool.py``): while the learner
               consumes buffer i, buffer i+1's env steps stay enqueued on the
               device. One update per buffer trajectory; the metrics drain
               one update late, as the jit tier's do.
  * ``host`` — bridged host envs (``bridge/``): a first-finisher
               ``HostVecEnv`` steps M = 2N envs on worker threads or spawned
               processes while the act step and the learner run on the
               device. Each act step's outputs (action, logp, value) cross to
               the host as one bytes-mode buffer: one ``pack`` launch, one
               copy. Rollout fragments accumulate per env, keyed by the
               pool's ``env_ids``, so GAE bootstraps and recurrent carries
               stay per-env correct whatever subset each batch holds.

The ``shard_map`` and ``async`` tiers, self-play, checkpoints and the
telemetry spans come with later slices.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.bridge.adapters import np_unemulate_bytes
from repro_torch.configs.base import TrainConfig
from repro_torch.core import spaces as sp
from repro_torch.core.emulation import emulate, flat_spec
from repro_torch.core.pool import Pool
from repro_torch.core.vector import VecEnv
from repro_torch.rl.learner import (init_train_state, make_ocean_learn,
                                    make_ocean_update)
from repro_torch.rl.rollout import RolloutCarry, Trajectory
from repro_torch.telemetry import TierTimer

METRIC_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
               "clipfrac", "grad_norm", "score", "episode_return", "episodes")

_LATER = {"shard_map": "the data-parallel slice",
          "async": "the async actor-learner slice (with checkpoints)"}
_TIERS = ("jit", "pool", "host")


def pack_metrics(m: dict) -> torch.Tensor:
    """Metrics dict of 0-dim device tensors → one f32 row."""
    return torch.stack([m[k].float().reshape(()) for k in METRIC_KEYS])


def unpack_metrics(row) -> dict:
    return {k: float(v) for k, v in zip(METRIC_KEYS, row)}


def _to_host(rows: torch.Tensor):
    """Start the copy of ``rows`` to the host; returns (host tensor, event
    to wait on, or None on the CPU)."""
    if rows.device.type != "cuda":
        return rows, None
    host = rows.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _fetch(host, done) -> list:
    if done is not None:
        done.synchronize()
    return host.tolist()


def act_transfer_spec(act_spec):
    """The bytes ``FlatSpec`` of one act step's outputs over its batch rows:
    the emulated action row (int32 components, or f32 for a continuous
    action), logp and value (f32)."""
    n = act_spec.num_components
    dtype = np.int32 if act_spec.kind == "discrete" else np.float32
    return flat_spec(sp.Dict({"action": sp.Box((n,), dtype),
                              "logp": sp.Box((), np.float32),
                              "value": sp.Box((), np.float32)}), "bytes")


class TrainEngine:
    """Owns the device-resident training state and runs the updates.

    ``env`` is a (usually ``Emulated``) batched env — for ``backend="host"``
    a ``bridge.HostVecEnv`` — ``policy`` an OceanPolicy, ``dist`` a
    distributions.Dist. One generator on ``device``, seeded with ``seed``,
    draws the parameters, the env states and then every update's randomness
    in order, so K updates in one launch equal K launches of one update.
    ``device=None`` means CUDA (raises without a Hopper card)."""

    def __init__(self, env, policy, tcfg: TrainConfig, dist, *,
                 seed: int = 0, device=None, backend: str = None,
                 updates_per_launch: int = None,
                 checkpoint_dir: Optional[str] = None):
        self.env, self.policy, self.tcfg, self.dist = env, policy, tcfg, dist
        self.backend = backend or tcfg.engine_backend
        if self.backend in _LATER:
            raise ValueError(f"engine backend {self.backend!r} comes with "
                             f"{_LATER[self.backend]}; the port runs "
                             f"{' | '.join(_TIERS)}")
        if self.backend not in _TIERS:
            raise ValueError(f"unknown engine backend {self.backend!r}; "
                             f"expected {' | '.join(_TIERS)}")
        self.K = updates_per_launch or tcfg.updates_per_launch
        if self.K < 1:
            raise ValueError(f"updates_per_launch must be >= 1, got {self.K}")
        if self.backend != "jit" and self.K != 1:
            raise ValueError(
                f"updates_per_launch={self.K} is the jit tier's knob; the "
                f"{self.backend} tier runs one update per trajectory (K=1)")
        self.checkpoint_dir = checkpoint_dir
        self.act_steps = 0          # pool/host tiers: act steps taken
        if self.backend == "host":
            for attr in ("recv", "send", "batch_envs", "num_agents"):
                if not hasattr(env, attr):
                    raise ValueError(
                        "backend='host' takes a bridge.HostVecEnv (see "
                        "bridge.wrap / bridge.make_host_engine), got "
                        f"{type(env).__name__} without {attr!r}")
            if env.batch_envs != tcfg.num_envs:
                raise ValueError(
                    f"HostVecEnv batches {env.batch_envs} envs but "
                    f"tcfg.num_envs={tcfg.num_envs}; size the bridge batch "
                    f"to the training config")
        self.device = _device.resolve(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ts = init_train_state(policy.init(self.generator))
        self.rc = None
        if self.backend == "host":
            self.hvec = self.vec = env
            self._learn = make_ocean_learn(policy, tcfg, dist)
            self._act = self._make_act()
            return
        if self.backend == "pool":
            self.pool = Pool(env, tcfg.num_envs, self.generator,
                             num_buffers=tcfg.pool_buffers)
            self.vec = self.pool.vec
            self._learn = make_ocean_learn(policy, tcfg, dist)
            self._act = self._make_act()
            self._boot = self._make_bootstrap()
            return
        self.vec = VecEnv(env, tcfg.num_envs)
        env_state, obs = self.vec.init(self.generator)
        B = self.vec.batch_size
        self.rc = RolloutCarry(
            env_state, obs, policy.initial_carry(B, self.device),
            torch.zeros(B, dtype=torch.bool, device=self.device))
        self.update = make_ocean_update(policy, self.vec.step, tcfg, dist)

    @property
    def batch_size(self) -> int:
        return self.vec.batch_size

    @property
    def steps_per_update(self) -> int:
        return self.tcfg.unroll_length * self.vec.batch_size

    def stats(self) -> dict:
        """Live snapshot: the backend name, and on the host tier the host
        pool's counters and liveness."""
        out = {"backend": self.backend}
        if self.backend == "host":
            out["pool"] = self.hvec.pool.stats()
        return out

    def close(self):
        """Release the host tier's worker threads or processes."""
        if self.backend == "host":
            self.hvec.close()

    def _maybe_checkpoint(self, updates_done: int):
        """The update-boundary checkpoint hook of the pool and host tiers:
        nothing without a checkpoint directory."""
        if self.checkpoint_dir is not None:
            raise NotImplementedError("checkpoints come with the checkpoint "
                                      "slice (checkpoint/ckpt.py)")

    _join_checkpoint = _maybe_checkpoint

    # -- jit tier --------------------------------------------------------------
    def launch(self, k: int) -> torch.Tensor:
        """Enqueue ``k`` updates; returns their (k, 10) metrics on the
        device. No host sync."""
        rows = []
        for _ in range(k):
            self.ts, self.rc, m = self.update(self.ts, self.rc,
                                              self.generator)
            rows.append(pack_metrics(m))
        return torch.stack(rows)

    def run(self, total_steps: int, *, target_score: Optional[float] = None,
            on_update: Optional[Callable] = None,
            on_launch: Optional[Callable] = None):
        """Train until env interactions ≥ total_steps (or solved).

        Returns ``(history, solved)``: per-update metric dicts with the
        ``env_steps``/``sps``/``launch_ms``/``fetch_ms`` keys.
        ``on_update(u, metrics)`` fires per update once its metrics are
        fetched; ``on_launch(updates_dispatched)`` right after each launch
        (jit) or update (pool, host) is enqueued."""
        runner = {"pool": self._run_pool,
                  "host": self._run_host}.get(self.backend, self._run_fused)
        return runner(total_steps, target_score=target_score,
                      on_update=on_update, on_launch=on_launch)

    def _run_fused(self, total_steps, *, target_score=None, on_update=None,
                   on_launch=None):
        spu = self.steps_per_update
        num_updates = max(1, total_steps // spu)
        history, pending, solved = [], deque(), None
        timer = TierTimer(spu)

        def drain_one():
            nonlocal solved
            u0, kk, host, done = pending.popleft()
            with timer.fetch():
                rows = _fetch(host, done)
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
                host, done = _to_host(self.launch(k))
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

    # -- pool and host tiers ---------------------------------------------------
    def _make_act(self):
        policy, dist = self.policy, self.dist

        @torch.no_grad()
        def act(params, obs, carry, reset, generator):
            logits, value, pc = policy.step(params, obs, carry, reset=reset)
            action = dist.sample(generator, logits)
            logp = dist.log_prob(logits, action)
            return action, logp, value, pc
        return act

    def _make_bootstrap(self):
        policy = self.policy

        @torch.no_grad()
        def boot(params, obs, carry, reset):
            _, value, _ = policy.step(params, obs, carry, reset=reset)
            return value
        return boot

    def _metrics_drainer(self, pending, history, timer, on_update,
                         target_score, st):
        """Shared pool/host-tier drain: fetch one update's metrics row
        (waits only on that update's learn), stamp the telemetry keys, fire
        ``on_update``, and latch the solving update into ``st["solved"]``.
        ``pending`` holds ``(update, host row, event)``."""

        def drain_one():
            uu, host, done = pending.popleft()
            with timer.fetch():
                md = unpack_metrics(_fetch(host, done))
            timer.stamp(md, (uu + 1) * timer.spu)
            history.append(md)
            if on_update is not None:
                on_update(uu, md)
            if (target_score is not None and st["solved"] is None
                    and md["episodes"] > 0 and md["score"] >= target_score):
                st["solved"] = md
        return drain_one

    def _after_update(self, u, m, pending, drain_one, target_score,
                      on_launch):
        """Queue update ``u``'s metrics for the host and drain: every update
        when early exit needs the score, else one update late, so the learn
        and the env steps behind it keep the device queue full."""
        pending.append((u, *_to_host(pack_metrics(m))))
        self._maybe_checkpoint(u + 1)
        if on_launch is not None:
            on_launch(u + 1)
        if target_score is not None:
            while pending:
                drain_one()
        elif len(pending) > 1:
            drain_one()

    def _run_pool(self, total_steps, *, target_score=None, on_update=None,
                  on_launch=None):
        """Host loop over the double-buffered pool. Each buffer's trajectory
        accumulates as in-flight device tensors; when a buffer reaches T
        steps its update is enqueued while the other buffers' env steps
        stay queued on the device — the paper's EnvPool overlap, learner
        edition."""
        tcfg, pool = self.tcfg, self.pool
        T, B = tcfg.unroll_length, pool.batch_size
        spu = T * B
        num_updates = max(1, total_steps // spu)
        nb = pool.num_buffers
        carry = [self.policy.initial_carry(B, self.device) for _ in range(nb)]
        carry0 = list(carry)
        recs = [[] for _ in range(nb)]
        history, pending, st = [], deque(), {"solved": None}
        timer = TierTimer(spu)
        drain_one = self._metrics_drainer(pending, history, timer,
                                          on_update, target_score, st)
        u = 0
        while u < num_updates and st["solved"] is None:
            obs, rew, done, info, b = pool.recv()
            if recs[b]:
                recs[b][-1] = recs[b][-1] + (rew, done, info)
            if len(recs[b]) == T and len(recs[b][-1]) == 8:
                last_value = self._boot(self.ts.params, obs, carry[b], done)
                cols = list(zip(*recs[b]))
                traj = Trajectory(
                    obs=torch.stack(cols[0]), actions=torch.stack(cols[1]),
                    logprobs=torch.stack(cols[2]),
                    values=torch.stack(cols[3]),
                    rewards=torch.stack(cols[5]), dones=torch.stack(cols[6]),
                    resets=torch.stack(cols[4]),
                    infos={k: torch.stack([i[k] for i in cols[7]])
                           for k in cols[7][0]})
                with timer.launch():
                    self.ts, m = self._learn(self.ts, carry0[b], traj,
                                             last_value, self.generator)
                carry0[b] = carry[b]
                recs[b] = []
                self._after_update(u, m, pending, drain_one, target_score,
                                   on_launch)
                u += 1
            # act before checking solved so the recv'd buffer is always
            # sent back — the pool stays reusable after an early exit
            action, logp, value, pc = self._act(self.ts.params, obs,
                                                carry[b], done,
                                                self.generator)
            self.act_steps += 1
            recs[b].append((obs, action, logp, value, done))
            carry[b] = pc
            pool.send(action, b)
        while pending:
            drain_one()
        self._join_checkpoint(u)
        return history, st["solved"]

    def _act_to_host(self, spec, obs, carry, done, staging):
        """One act step of the host tier: the act on the device, then its
        action, logp and value packed into one bytes-mode buffer (one
        ``pack`` launch) and brought to the host by one copy into the
        pinned ``staging`` buffer. Returns the three as numpy arrays that
        equal the device tensors byte for byte, and the new carry."""
        obs_t = torch.from_numpy(obs).to(self.device)
        done_t = torch.from_numpy(done).to(self.device)
        action, logp, value, pc = self._act(self.ts.params, obs_t, carry,
                                            done_t, self.generator)
        packed = emulate(spec, {"action": action, "logp": logp,
                                "value": value})
        if staging is None:                     # the CPU: no copy needed
            host = packed.numpy()
        else:
            staging.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            host = staging.numpy()
        self.act_steps += 1
        out = np_unemulate_bytes(spec, host)
        return out["action"], out["logp"], out["value"], pc

    def _run_host(self, total_steps, *, target_score=None, on_update=None,
                  on_launch=None):
        """First-finisher loop over the bridged ``HostVecEnv``: each recv is
        the N (of M = pool_buffers·N) envs that finished stepping first;
        while the device computes their actions, the other M−N envs keep
        stepping on the workers — the paper's EnvPool overlap with the
        learner on the device. Rollout fragments accumulate per env (keyed
        by ``env_ids``), so every fragment is a contiguous T-step slice of
        one env's experience with its own recurrent carry and GAE
        bootstrap; an update fires whenever N fragments are ready, batching
        whichever envs filled first."""
        tcfg, hv = self.tcfg, self.hvec
        T = tcfg.unroll_length
        Nb, A = hv.batch_envs, hv.num_agents
        spu = T * Nb * A
        num_updates = max(1, total_steps // spu)
        M = hv.num_envs
        recurrent = self.policy.recurrent
        carry = [self.policy.initial_carry(A, self.device) for _ in range(M)]
        carry0 = list(carry)
        recs = [[] for _ in range(M)]
        ready = deque()
        history, pending, st = [], deque(), {"solved": None}
        timer = TierTimer(spu)
        drain_one = self._metrics_drainer(pending, history, timer,
                                          on_update, target_score, st)
        spec = act_transfer_spec(hv.act_spec)
        staging = (torch.empty((Nb * A, spec.total), dtype=torch.uint8,
                               pin_memory=True)
                   if self.device.type == "cuda" else None)
        u = 0
        while u < num_updates and st["solved"] is None:
            obs, rew, done, info, ids = hv.recv(
                timeout=tcfg.host_recv_timeout)
            obs_e = obs.reshape(Nb, A, -1)
            rew_e = rew.reshape(Nb, A)
            done_e = done.reshape(Nb, A)
            # complete each env's previous record with its step outcome
            for j, i in enumerate(ids):
                if recs[i]:
                    inf = {k: info[k][j] for k in info}
                    recs[i][-1] = recs[i][-1] + (rew_e[j], done_e[j], inf)
            # act on the batch (device) while the other envs step (host)
            cb = (tuple(torch.cat(xs) for xs in zip(*(carry[i]
                                                      for i in ids)))
                  if recurrent else None)
            action, logp, value, pc = self._act_to_host(spec, obs, cb, done,
                                                        staging)
            act_e = action.reshape((Nb, A) + action.shape[1:])
            logp_e = logp.reshape(Nb, A)
            val_e = value.reshape(Nb, A)
            # harvest full fragments (bootstrapped by this batch's values),
            # then start each env's next fragment with this step
            for j, i in enumerate(ids):
                if len(recs[i]) == T and len(recs[i][-1]) == 8:
                    ready.append((recs[i], carry0[i], val_e[j]))
                    recs[i] = []
                    carry0[i] = carry[i]
                recs[i].append((obs_e[j], act_e[j], logp_e[j], val_e[j],
                                done_e[j]))
                if recurrent:
                    carry[i] = tuple(x[j * A:(j + 1) * A] for x in pc)
            hv.send(action, ids)
            # one PPO update per Nb collected fragments
            while (len(ready) >= Nb and u < num_updates
                   and st["solved"] is None):
                frags = [ready.popleft() for _ in range(Nb)]
                traj, c0, last_value = self._stack_fragments(frags, T, A,
                                                             recurrent)
                with timer.launch():
                    traj = self._to_device(traj)
                    last_value = torch.from_numpy(last_value).to(self.device)
                    self.ts, m = self._learn(self.ts, c0, traj, last_value,
                                             self.generator)
                self._after_update(u, m, pending, drain_one, target_score,
                                   on_launch)
                u += 1
        while pending:
            drain_one()
        self._join_checkpoint(u)
        return history, st["solved"]

    def _to_device(self, traj: Trajectory) -> Trajectory:
        put = lambda x: torch.from_numpy(x).to(self.device)
        return Trajectory(*(put(x) for x in traj[:7]),
                          infos={k: put(v) for k, v in traj.infos.items()})

    @staticmethod
    def _stack_fragments(frags, T, A, recurrent):
        """N per-env fragments (each T steps of (A, …) rows) → one
        (T, N·A)-batched numpy Trajectory + per-row carry0 (device) +
        bootstrap values."""
        Nb = len(frags)
        cols = [list(zip(*rec)) for rec, _c0, _bv in frags]

        def field(k, dtype=None):
            x = np.stack([np.stack(c[k]) for c in cols], axis=1)
            x = x.reshape((T, Nb * A) + x.shape[3:])
            return x if dtype is None else x.astype(dtype)

        infos = {key: np.stack([np.stack([r[key] for r in c[7]])
                                for c in cols], axis=1)
                 for key in cols[0][7][0]}               # (T, Nb) per key
        traj = Trajectory(
            obs=field(0, np.float32), actions=field(1),
            logprobs=field(2, np.float32), values=field(3, np.float32),
            rewards=field(5, np.float32), dones=field(6, bool),
            resets=field(4, bool), infos=infos)
        c0 = (tuple(torch.cat(xs) for xs in zip(*(f[1] for f in frags)))
              if recurrent else None)
        last_value = np.concatenate([np.asarray(f[2]) for f in frags])
        return traj, c0, last_value
