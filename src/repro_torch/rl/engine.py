"""TrainEngine: the PPO training loop behind one ``run(total_steps)``.

The counterpart of ``repro/rl/engine.py``'s five tiers:

  * ``jit``  — a launch is K updates enqueued eagerly on the device, none of
               which syncs with the host: the metrics of each update are
               packed into one row of a ``(K, 10)`` device tensor, copied to
               the host once per launch, asynchronously. The engine fetches
               it one launch late (so the host enqueues launch i+1 while the
               device runs launch i), or at once when ``target_score`` is
               set, which is checked at launch boundaries. ``num_shards`` S
               emulates the data-parallel layout in one process: one
               generator per env block, minibatches joined across blocks.
  * ``shard_map`` — data-parallel over the ranks of a ``torch.distributed``
               process group, one rank per process (PyTorch's SPMD idiom
               for what ``shard_map`` does in one): rank s steps env block
               s of S, draws from block s's generator what block s of the
               S-block emulation draws, and learns with its gradients, loss
               and stats averaged by one all-reduce a minibatch
               (``learner.make_ocean_learn(group=)``), so its metrics — and
               every decision made from them — are the same on every rank.
               Rank 0's params are broadcast at construction. Without a
               group and at world size 1 the engine makes its own: NCCL on
               a CUDA device (never gloo), gloo on the CPU
               (``launch/mesh.py``). At world size 1 it is the jit tier bit
               for bit.
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

  * ``async`` — decoupled actor–learner (``distributed/actor_learner.py``):
               N spawned actor processes act and step disjoint env shards on
               the engine's device and stream version-tagged fragments
               through a shared-memory slab; the learner batches one
               fragment per shard, applies the staleness policy
               (``tcfg.staleness_mode``: drop stale fragments, or keep them
               under V-trace clamps), learns (GAE through the ``gae``
               kernel in drop mode), and seqlock-publishes the new params.
               The loop runs through ``distributed/fault.ResilientLoop``,
               dead actors are resharded to survivors, and slow ones are
               straggler-flagged.

Checkpoints fire at update boundaries: with ``checkpoint_dir`` set, every
``tcfg.checkpoint_every`` updates the resumable state saves asynchronously
(copied to the host at the call, written on a thread): the TrainState, the
generator's state (where the reference saves its PRNG key; one per block
under ``num_shards``) and, on the jit tier, the rollout carry (env states,
obs, recurrent carry). ``restore()`` resumes a run so that on the jit tier
interrupted-then-resumed is bitwise equal to uninterrupted; the pool, host
and async tiers resume the learner and the generator, and re-seed their
env states, as the reference does. On the ``shard_map`` tier a save is
collective: the rollout carry is gathered into the global layout and
every rank's generator state beside it, rank 0 writes (synchronously),
and a barrier follows; the train state and carry restore on any S, the
generators where S is the one saved (else each rank's is re-seeded).

Self-play (``league/``): construct with ``selfplay=SelfPlay(next_opponent,
L)`` on the jit or shard_map tier. Agent rows [0, L) are the learner, rows
[L, A) act under frozen params that ``next_opponent()`` returns (e.g. from
the ``PolicyStore``), called on the host once per launch (on the shard_map
tier by rank 0, which broadcasts them), so the K updates of a launch face
one opponent; PPO and GAE run over the learner rows only. The rollout
carry is a ``SelfPlayCarry`` (the opponent rows' recurrent carry beside
the learner's), saved and restored like any rollout carry.
"""
from __future__ import annotations

import os
import time
from collections import deque
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.bridge.adapters import np_unemulate_bytes
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.core import spaces as sp
from repro_torch.core.emulation import emulate, flat_spec
from repro_torch.core.pool import Pool
from repro_torch.core.vector import VecEnv, block_generators
from repro_torch.distributed import sharding as shd
from repro_torch.rl.learner import (TrainState, init_train_state,
                                    make_ocean_learn, make_ocean_update,
                                    make_vtrace_adv)
from repro_torch.rl.rollout import RolloutCarry, Trajectory
from repro_torch.telemetry import TierTimer
from repro_torch.telemetry import enabled as tel_enabled
from repro_torch.telemetry import flush as tel_flush
from repro_torch.telemetry import registry as tel_registry
from repro_torch.telemetry import span as tel_span

METRIC_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl",
               "clipfrac", "grad_norm", "score", "episode_return", "episodes")

_TIERS = ("jit", "shard_map", "pool", "host", "async")
_FUSED = ("jit", "shard_map")


def _check_mesh(mesh, num_envs: int):
    """The shard_map tier's mesh: data axes to shard over, no other axis
    wider than 1, and envs that split evenly over its data ranks."""
    axes = shd.data_axes(mesh)
    if not axes:
        raise ValueError(
            f"mesh {mesh.axis_names} has no data axes ('pod'/'data') to "
            f"shard Ocean PPO over")
    wide = [a for a in mesh.axis_names if a not in axes and mesh.shape[a] > 1]
    if wide:
        raise ValueError(
            f"mesh axes {wide} replicate Ocean PPO; the model axis comes "
            f"with the LM-sharding slice (its size must be 1 here)")
    S = shd.dp_size(mesh)
    if num_envs % S:
        raise ValueError(f"num_envs={num_envs} not divisible by the mesh "
                         f"data-parallel size {S}")


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
    With S env blocks (``num_shards`` on the jit tier, the ranks on the
    shard_map tier) block 0 keeps that generator and block s > 0 draws
    from one seeded with ``core.vector.block_seed(seed, s)``.
    ``device=None`` means CUDA (raises without a Hopper card). On the async
    tier ``seed`` also seeds the actors' (shard, epoch) streams.

    ``mesh`` (shard_map tier; ``launch.mesh.make_mesh``) names the ranks'
    axes: Ocean PPO shards over its data axes. ``num_shards`` (jit tier
    only) emulates the S-way block layout in one process — what the
    parity tests hold an S-rank run against."""

    def __init__(self, env, policy, tcfg: TrainConfig, dist, *,
                 seed: int = 0, device=None, backend: str = None,
                 updates_per_launch: int = None,
                 checkpoint_dir: Optional[str] = None, selfplay=None,
                 mesh=None, num_shards: int = 1):
        self.env, self.policy, self.tcfg, self.dist = env, policy, tcfg, dist
        self.backend = backend or tcfg.engine_backend
        if self.backend not in _TIERS:
            raise ValueError(f"unknown engine backend {self.backend!r}; "
                             f"expected {' | '.join(_TIERS)}")
        self.K = updates_per_launch or tcfg.updates_per_launch
        if self.K < 1:
            raise ValueError(f"updates_per_launch must be >= 1, got {self.K}")
        if self.backend not in _FUSED and self.K != 1:
            raise ValueError(
                f"updates_per_launch={self.K} is the fused tiers' knob; the "
                f"{self.backend} tier runs one update per trajectory (K=1)")
        if self.backend != "shard_map" and mesh is not None:
            raise ValueError(f"mesh is only meaningful for the shard_map "
                             f"tier, not backend={self.backend!r}")
        if self.backend == "shard_map":
            if num_shards != 1:
                raise ValueError("num_shards is derived from the mesh on "
                                 "the shard_map tier; pass a mesh instead")
            if mesh is not None:
                _check_mesh(mesh, tcfg.num_envs)
        elif num_shards < 1 or tcfg.num_envs % num_shards:
            raise ValueError(
                f"num_envs={tcfg.num_envs} not divisible by num_shards="
                f"{num_shards}: the S-block emulation would silently drop "
                f"the tail envs from every minibatch")
        elif self.backend != "jit" and num_shards != 1:
            raise ValueError(f"num_shards emulates the data-parallel layout "
                             f"on the jit tier, not backend="
                             f"{self.backend!r}")
        self.selfplay = selfplay
        if selfplay is not None:
            if self.backend not in _FUSED:
                raise ValueError(
                    f"selfplay runs on the device-resident tiers (jit and "
                    f"shard_map: the opponent swap is a launch-boundary "
                    f"decision), not backend={self.backend!r}")
            A = getattr(env, "num_agents", 1)
            if A < 2:
                raise ValueError(
                    f"selfplay needs a multi-agent env to split rows "
                    f"between learner and opponent; num_agents={A}")
            self._sp_agents = selfplay.learner_agents or A // 2
            if not 0 < self._sp_agents < A:
                raise ValueError(
                    f"learner_agents={self._sp_agents} must split "
                    f"num_agents={A} into two non-empty sides")
        self.checkpoint_dir = checkpoint_dir
        self._ckpt_thread = None
        self._resume_update = 0     # updates done before this run (restore)
        self._saved_upto = 0
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
        if self.backend == "async":
            if tcfg.staleness_mode not in ("drop", "vtrace"):
                raise ValueError(
                    f"staleness_mode={tcfg.staleness_mode!r}; expected "
                    f"'drop' (discard fragments older than max_staleness) "
                    f"or 'vtrace' (importance-clip them)")
            for attr in ("init", "step", "reset"):
                if not hasattr(env, attr):
                    raise ValueError(
                        "backend='async' takes a batched (Emulated) env "
                        "whose actors rebuild it in their processes, got "
                        f"{type(env).__name__} without {attr!r}")
        self.device = _device.resolve(device)
        self.seed = seed
        self.group, self.rank, self.num_shards = None, 0, num_shards
        self._own_group = False
        if self.backend == "shard_map":
            self.mesh = self._join_group(mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ts = init_train_state(policy.init(self.generator))
        # what every update draws from: the generator, or one per block
        self._draw = self.generator
        if self.group is not None:
            # rank 0's params on every rank; then rank s's own block stream
            self.ts = TrainState(shd.broadcast_tree(self.ts.params,
                                                    self.group),
                                 self.ts.opt, self.ts.step)
            if self.rank > 0:
                self.generator = self._draw = block_generators(
                    seed, self.num_shards, self.device)[self.rank]
        elif self.num_shards > 1:
            self._draw = block_generators(seed, self.num_shards, self.device,
                                          first=self.generator)
        self.rc = None
        if self.backend == "async":
            from repro_torch.distributed.actor_learner import AsyncRollouts
            A = getattr(env, "num_agents", 1)
            # batch bookkeeping only: the envs live in the actor processes
            self.vec = SimpleNamespace(batch_size=tcfg.num_envs * A,
                                       num_envs=tcfg.num_envs, num_agents=A)
            adv = (make_vtrace_adv(policy, dist, tcfg,
                                   rho_clip=tcfg.vtrace_rho,
                                   c_clip=tcfg.vtrace_c)
                   if tcfg.staleness_mode == "vtrace" else None)
            self._learn = make_ocean_learn(policy, tcfg, dist, adv_fn=adv)
            self.rollouts = AsyncRollouts(env, policy, dist, tcfg,
                                          params0=self.ts.params, seed=seed,
                                          device=self.device)
            self._dropped = 0
            self._version = 0
            self._last_ages = []
            # the last run's learner wall time in all, until its first
            # batch (the actors' start-up), and waiting on each batch
            self.run_s = self.first_batch_s = 0.0
            self.collect_waits = []
            return
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
        # this rank's envs: all of them, or its block on the shard_map tier
        ranks = 1 if self.group is None else self.num_shards
        self.vec = VecEnv(env, tcfg.num_envs // ranks)
        env_state, obs = self.vec.init(self._draw)
        B = self.vec.batch_size
        done0 = torch.zeros(B, dtype=torch.bool, device=self.device)
        layout = {"num_shards": 1 if self.group is not None
                  else self.num_shards, "group": self.group}
        if selfplay is not None:
            from repro_torch.league.selfplay import (SelfPlayCarry,
                                                     make_selfplay_update)
            N, A, L = self.vec.num_envs, self.vec.num_agents, self._sp_agents
            self.rc = SelfPlayCarry(
                env_state, obs, policy.initial_carry(N * L, self.device),
                policy.initial_carry(N * (A - L), self.device), done0)
            self.update = make_selfplay_update(policy, self.vec.step, tcfg,
                                               dist, N, A, L, **layout)
            return
        self.rc = RolloutCarry(
            env_state, obs, policy.initial_carry(B, self.device), done0)
        self.update = make_ocean_update(policy, self.vec.step, tcfg, dist,
                                        **layout)

    def _join_group(self, mesh):
        """The shard_map tier's process group (made here at world size 1
        when none exists) and its mesh, checked against the group."""
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_mod
        self._own_group = mesh_mod.init_process_group(self.device)
        try:
            self.group = dist.group.WORLD
            W, self.rank = dist.get_world_size(), dist.get_rank()
            if mesh is None:
                mesh = mesh_mod.make_mesh((W,), ("data",))
            _check_mesh(mesh, self.tcfg.num_envs)
            if mesh.size != W:
                raise ValueError(f"mesh {mesh.shape} covers {mesh.size} "
                                 f"ranks; the process group has {W}")
            self.num_shards = W
            shd.reset_collectives()
            return mesh
        except BaseException:
            self.close()
            raise

    @property
    def batch_size(self) -> int:
        """The batch rows of one env step over every rank."""
        ranks = 1 if self.group is None else self.num_shards
        return self.vec.batch_size * ranks

    @property
    def steps_per_update(self) -> int:
        return self.tcfg.unroll_length * self.batch_size

    def stats(self) -> dict:
        """Live snapshot: the backend name, on the host tier the host pool's
        counters and liveness, on the async tier the actors' slab rows,
        liveness, reshards and straggler monitors, on the shard_map tier
        the world size, the rank and the all-reduces issued."""
        out = {"backend": self.backend}
        if self.backend == "host":
            out["pool"] = self.hvec.pool.stats()
        if self.backend == "async":
            out["rollouts"] = self.rollouts.stats()
        if self.backend == "shard_map":
            out.update(world_size=self.num_shards, rank=self.rank,
                       all_reduces=shd.COLLECTIVES["all_reduce"])
        return out

    def close(self):
        """Release the host tier's worker threads or processes, or the
        async tier's actor processes and slab; join a pending save; on the
        shard_map tier destroy the process group the engine made."""
        self._join_checkpoint()
        if self.backend == "host":
            self.hvec.close()
        if self.backend == "async":
            self.rollouts.close()
        if self._own_group:
            import torch.distributed as dist
            self._own_group = False
            dist.destroy_process_group()

    # -- checkpoints -------------------------------------------------------------
    def _gen_states(self):
        """The generator states a checkpoint holds: (S, L) uint8, one row
        per block (on the shard_map tier gathered from every rank;
        collective)."""
        if self.group is not None:
            st = self.generator.get_state().to(self.device)
            return shd.all_gather_stack(st, self.group).cpu()
        return torch.stack([g.get_state() for g in self._draw])

    def _ckpt_tree(self, update: int) -> dict:
        tree = {"ts": self.ts, "update": np.asarray(update, np.int64)}
        if self._draw is self.generator and self.group is None:
            tree["generator"] = self.generator.get_state()
        else:
            tree["generators"] = self._gen_states()
            tree["shards"] = np.asarray(self.num_shards, np.int64)
        if self.rc is not None:
            tree["rc"] = (self.rc if self.group is None
                          else shd.gather_blocks(self.rc, self.group))
        return tree

    def _ckpt_like(self) -> dict:
        return self._ckpt_tree(0)

    def save_checkpoint(self, update: int = None, async_: bool = False):
        """Save the resumable state (TrainState, the generator's state, the
        update count and, on the jit tier, the rollout carry) under
        ``checkpoint_dir``. Every tensor is copied to the host at this call;
        async mode writes the files on a thread, and a previous async save
        joins first. Returns the committed path or the thread. On the
        shard_map tier every rank calls it: rank 0 writes the gathered
        state at once (``async_`` does not apply) and a barrier follows."""
        if self.checkpoint_dir is None:
            raise ValueError("engine has no checkpoint_dir")
        self._join_checkpoint()
        update = self._saved_upto if update is None else update
        tree = self._ckpt_tree(update)
        if self.group is not None:
            import torch.distributed as dist
            out = None
            if self.rank == 0:
                out = ckpt.save(self.checkpoint_dir, tree, step=update,
                                keep=self.tcfg.keep_checkpoints)
            dist.barrier(self.group)
            return out
        out = ckpt.save(self.checkpoint_dir, tree,
                        step=update, async_=async_,
                        keep=self.tcfg.keep_checkpoints)
        if async_:
            self._ckpt_thread = out
        return out

    def restore(self, directory: Optional[str] = None) -> int:
        """Restore the newest committed checkpoint and return the update
        count it was taken at; ``run`` then continues from there."""
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise ValueError("engine has no checkpoint_dir to restore from")
        if self.group is not None:
            return self._restore_ranks(directory)
        tree = ckpt.restore(directory, self._ckpt_like())
        self.ts = TrainState(*tree["ts"])
        if self.rc is not None:
            self.rc = tree["rc"]
        if "generator" in tree:
            self.generator.set_state(tree["generator"])
        else:
            for g, st in zip(self._draw, tree["generators"]):
                g.set_state(st.clone())
        self._resume_update = self._saved_upto = int(tree["update"])
        return self._resume_update

    def _restore_ranks(self, directory: str) -> int:
        """The shard_map tier's restore: every rank reads the global
        checkpoint and keeps its own block of the carry; its generator
        state where the checkpoint was taken at this S, else a generator
        re-seeded from (seed + update, rank)."""
        path = (directory
                if os.path.exists(os.path.join(directory, "index.json"))
                else ckpt.latest(directory))
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        like = {"ts": self.ts, "update": np.asarray(0, np.int64),
                "shards": np.asarray(0, np.int64)}
        if self.rc is not None:
            like["rc"] = shd.gather_blocks(self.rc, self.group)
        tree = ckpt.restore(path, like)
        S, r = self.num_shards, self.rank
        update = int(tree["update"])
        self.ts = TrainState(*tree["ts"])
        if self.rc is not None:
            self.rc = shd.tree_map(lambda x: x.clone(),
                                   shd.block(tree["rc"], S, r))
        saved = int(tree["shards"])
        if saved == S:
            st = self.generator.get_state()
            gens = ckpt.restore(path, {"generators": torch.empty(
                (S, st.numel()), dtype=torch.uint8)})["generators"]
            # a row of its own: set_state reads a view's storage from the
            # start, not from the view's offset
            self.generator.set_state(gens[r].clone())
        else:
            self.generator = self._draw = block_generators(
                self.seed + update, S, self.device)[r]
        self._resume_update = self._saved_upto = update
        return update

    def _maybe_checkpoint(self, updates_done: int):
        """The update-boundary checkpoint hook: an async save every
        ``tcfg.checkpoint_every`` updates when there is a directory."""
        ce = self.tcfg.checkpoint_every
        if self.checkpoint_dir is None or ce <= 0:
            return
        if updates_done // ce > self._saved_upto // ce:
            self._saved_upto = updates_done
            self.save_checkpoint(updates_done, async_=True)

    def _join_checkpoint(self):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    # -- jit tier --------------------------------------------------------------
    def launch(self, k: int, opp_params=None) -> torch.Tensor:
        """Enqueue ``k`` updates; returns their (k, 10) metrics on the
        device. No host sync. In self-play all ``k`` face ``opp_params``
        (a param dict on the engine's device; by default
        ``selfplay.next_opponent()``, called here, once — on the shard_map
        tier by rank 0, and broadcast)."""
        if self.selfplay is not None and opp_params is None:
            if self.group is None:
                opp_params = self.selfplay.next_opponent()
            else:
                # rank 0 draws; the others' params give the shapes only
                opp_params = shd.broadcast_tree(
                    self.selfplay.next_opponent() if self.rank == 0
                    else self.ts.params, self.group)
        extra = () if self.selfplay is None else (opp_params,)
        rows = []
        for _ in range(k):
            self.ts, self.rc, m = self.update(self.ts, self.rc, *extra,
                                              self._draw)
            rows.append(pack_metrics(m))
        return torch.stack(rows)

    def run(self, total_steps: int, *, target_score: Optional[float] = None,
            on_update: Optional[Callable] = None,
            on_launch: Optional[Callable] = None, logger=None):
        """Train until env interactions ≥ total_steps (or solved). A
        restored engine continues from its update count.

        Returns ``(history, solved)``: per-update metric dicts with the
        ``env_steps``/``sps``/``launch_ms``/``fetch_ms`` keys.
        ``on_update(u, metrics)`` fires per update once its metrics are
        fetched; ``on_launch(updates_dispatched)`` right after each launch
        (jit) or update (pool, host, async) is enqueued. ``logger`` (a
        ``utils.metrics.MetricsLogger``) streams every fetched record and
        is flushed on any exit; with span tracing on, a registry snapshot
        is appended after a clean run."""
        runner = {"pool": self._run_pool, "host": self._run_host,
                  "async": self._run_async}.get(self.backend,
                                                self._run_fused)
        try:
            with tel_span("engine.run"):
                history, solved = runner(
                    total_steps, target_score=target_score,
                    on_update=on_update, on_launch=on_launch, logger=logger)
            if logger is not None and history and tel_enabled():
                tel_registry().emit(logger, int(history[-1]["env_steps"]))
            return history, solved
        finally:
            if logger is not None:
                logger.flush()
            tel_flush()

    def _run_fused(self, total_steps, *, target_score=None, on_update=None,
                   on_launch=None, logger=None):
        spu = self.steps_per_update
        num_updates = max(1, total_steps // spu)
        history, pending, solved = [], deque(), None
        # resumed runs: sps counts only this run's work
        timer = TierTimer(spu, self._resume_update * spu)
        upd_ctr = tel_registry().counter("engine.updates", tier=self.backend)

        def drain_one():
            nonlocal solved
            u0, kk, host, done = pending.popleft()
            with timer.fetch():
                rows = _fetch(host, done)
            for i in range(kk):
                md = unpack_metrics(rows[i])
                timer.stamp(md, (u0 + i + 1) * spu)
                history.append(md)
                upd_ctr.inc()
                if logger is not None:
                    logger.log(md["env_steps"], md, flush=False)
                if on_update is not None:
                    on_update(u0 + i, md)
                if (target_score is not None and solved is None
                        and md["episodes"] > 0
                        and md["score"] >= target_score):
                    solved = md
            if logger is not None:
                logger.flush()

        u = self._resume_update
        while u < num_updates:
            k = min(self.K, num_updates - u)
            with timer.launch():
                host, done = _to_host(self.launch(k))
            pending.append((u, k, host, done))
            u += k
            self._maybe_checkpoint(u)
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
        self._join_checkpoint()
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
                         target_score, st, logger=None):
        """Shared pool/host-tier drain: fetch one update's metrics row
        (waits only on that update's learn), stamp the telemetry keys, fire
        ``on_update``, and latch the solving update into ``st["solved"]``.
        ``pending`` holds ``(update, host row, event)``."""
        upd_ctr = tel_registry().counter("engine.updates", tier=self.backend)

        def drain_one():
            uu, host, done = pending.popleft()
            with timer.fetch():
                md = unpack_metrics(_fetch(host, done))
            timer.stamp(md, (uu + 1) * timer.spu)
            history.append(md)
            upd_ctr.inc()
            if logger is not None:
                logger.log(md["env_steps"], md)
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
                  on_launch=None, logger=None):
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
        timer = TierTimer(spu, self._resume_update * spu)
        drain_one = self._metrics_drainer(pending, history, timer,
                                          on_update, target_score, st,
                                          logger)
        u = self._resume_update
        while u < num_updates and st["solved"] is None:
            with tel_span("pool.recv"):
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
        self._join_checkpoint()
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
                  on_launch=None, logger=None):
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
        timer = TierTimer(spu, self._resume_update * spu)
        drain_one = self._metrics_drainer(pending, history, timer,
                                          on_update, target_score, st,
                                          logger)
        spec = act_transfer_spec(hv.act_spec)
        staging = (torch.empty((Nb * A, spec.total), dtype=torch.uint8,
                               pin_memory=True)
                   if self.device.type == "cuda" else None)
        u = self._resume_update
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
        self._join_checkpoint()
        return history, st["solved"]

    # -- async actor–learner tier ----------------------------------------------
    def _collect_fragments(self, nf: int) -> list:
        """``nf`` fresh-enough fragments from the actors. In drop mode,
        fragments older than ``max_staleness`` learner versions are
        discarded before batching (the actors keep producing, so this
        converges); in vtrace mode every fragment batches and the
        importance clamps do the correcting."""
        tcfg = self.tcfg
        out = []
        while len(out) < nf:
            got = self.rollouts.wait_fragments(
                nf - len(out), timeout=tcfg.async_recv_timeout)
            for f in got:
                if (tcfg.staleness_mode == "drop"
                        and self._version - f.version > tcfg.max_staleness):
                    self._dropped += 1
                    continue
                out.append(f)
        return out

    def _run_async(self, total_steps, *, target_score=None, on_update=None,
                   on_launch=None, logger=None):
        """The learner half of the actor–learner split, through the
        ResilientLoop: collect one update's fragments from the slab, learn,
        publish the new params version. Fragments are a live stream, so
        recovery retries the current batch and restores only a checkpoint
        at ``steps_done``. Checkpoints are the engine's {ts, generator,
        update} tree, so ``restore()`` + ``run()`` resumes a killed learner
        at its update count (the actors re-seed from the published params,
        as the pool and host tiers re-seed their env states)."""
        from repro_torch.distributed.actor_learner import stack_fragments
        from repro_torch.distributed.fault import ResilientLoop
        tcfg, ro = self.tcfg, self.rollouts
        spu = self.steps_per_update
        num_updates = max(1, total_steps // spu)
        nf = ro.spec.num_shards          # one fragment per env shard
        history, st = [], {"solved": None}
        timer = TierTimer(spu, self._resume_update * spu)
        reg = tel_registry()
        upd_ctr = reg.counter("engine.updates", tier="async")
        age_hist = reg.histogram("async.frag_age",
                                 edges=(0.0, 1.0, 2.0, 4.0, 8.0))
        self.first_batch_s, self.collect_waits = 0.0, []
        t_run = time.perf_counter()

        self._version = self._resume_update
        ro.publish(self.ts.params, self._version)

        def step_fn(state, frags):
            # the generator's state travels in ``state`` (the reference's
            # key), so a restore inside the loop restores it too
            self.generator.set_state(state["generator"])
            with tel_span("engine.stack_fragments"):
                traj, last_value = stack_fragments(frags)
            with timer.launch():
                traj = self._to_device(traj)
                last_value = torch.from_numpy(last_value).to(self.device)
                ts, m = self._learn(TrainState(*state["ts"]), None, traj,
                                    last_value, self.generator)
            u = int(state["update"]) + 1
            # publish inside the step: the host copy of a poisoned update
            # raises before the slab is touched, so actors only ever see
            # committed params
            ro.publish(ts.params, u)
            return ({"ts": ts, "generator": self.generator.get_state(),
                     "update": np.asarray(u, np.int64)}, m)

        loop = ResilientLoop(
            step_fn, self.checkpoint_dir,
            save_every=(tcfg.checkpoint_every
                        if self.checkpoint_dir is not None else 0),
            async_save=True, keep=tcfg.keep_checkpoints)
        loop.steps_done = self._resume_update
        state = self._ckpt_tree(self._resume_update)

        def frag_stream():
            while loop.steps_done < num_updates and st["solved"] is None:
                t0 = time.perf_counter()
                with tel_span("engine.collect"):
                    batch = self._collect_fragments(nf)
                t1 = time.perf_counter()
                self.collect_waits.append(t1 - t0)
                if not self.first_batch_s:
                    self.first_batch_s = t1 - t_run
                self._last_ages = [self._version - f.version for f in batch]
                for a in self._last_ages:
                    age_hist.observe(a)
                yield batch

        def on_metrics(u, m):
            self._version = ro.version    # published by step_fn
            with timer.fetch():
                md = unpack_metrics(torch.stack(
                    [m[k].float().reshape(()) for k in METRIC_KEYS]).tolist())
            timer.stamp(md, u * spu)
            ages = self._last_ages
            md["frag_age_mean"] = float(np.mean(ages)) if ages else 0.0
            md["frag_age_max"] = float(np.max(ages)) if ages else 0.0
            md["dropped_fragments"] = self._dropped
            md["stragglers"] = int(np.sum(ro.straggler_flags))
            md["actors_alive"] = len(ro.alive_actors())
            md["reshards"] = len(ro.events)
            history.append(md)
            upd_ctr.inc()
            if logger is not None:
                logger.log(md["env_steps"], md)
            if on_update is not None:
                on_update(u - 1, md)
            if on_launch is not None:
                on_launch(u)
            if (target_score is not None and st["solved"] is None
                    and md["episodes"] > 0 and md["score"] >= target_score):
                st["solved"] = md

        try:
            state = loop.run(state, frag_stream(), on_metrics=on_metrics)
        finally:
            self.run_s = time.perf_counter() - t_run
            loop.join_save()    # an interrupted run still commits its save
        self.ts = TrainState(*state["ts"])
        self.generator.set_state(state["generator"])
        self._resume_update = self._saved_upto = int(state["update"])
        if self.checkpoint_dir is not None and tcfg.checkpoint_every > 0:
            # final commit: kill-then-resume ends at the same update count
            # (and params) as an uninterrupted run
            self.save_checkpoint(self._resume_update, async_=False)
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
