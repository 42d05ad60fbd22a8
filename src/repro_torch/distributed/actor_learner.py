"""Async actor–learner topology: the engine's ``async`` tier (IMPALA-shaped).

The counterpart of ``repro/distributed/actor_learner.py``. N actor
processes (spawn context, one fresh interpreter each) run the policy and
step their envs on ``ActorConfig.device`` — the learner's device, so each
actor on the card opens its own CUDA context, which time-slices with the
learner's — and stream fixed-size rollout fragments through a shared-memory
slab. The learner consumes fragments at its own rate, applies the staleness
policy (drop, or V-trace importance clamps — rl/learner.py), and broadcasts
refreshed params through a versioned seqlock region of the same slab. A
slow actor no longer stalls the update cadence: the paper's EnvPool "never
wait for the slowest" applied across processes.

Slab layout (core/shm.py idiom — numpy views over one segment, one-writer
ctrl bytes, no locks):

  * param region — seqlock (i64 counter, odd while the learner writes) +
    version + each param leaf's raw bytes, so any dtype goes through.
    Actors re-read only when the version changes; a torn read is detected
    by the counter and retried.
  * fragment rings — per env shard, ``actor_slots`` slots of
    EMPTY → WRITING → FULL (actor) → EMPTY (learner after copy-out). The
    small ring is deliberate backpressure: an actor that gets ahead of the
    learner blocks on a full ring, bounding how stale its next fragment
    can be.
  * assignment table — ``assign[shard] -> actor`` + an epoch per shard.
    When the learner finds a dead actor (process gone without an EXIT
    status) it reassigns the actor's shards to the least-loaded survivors
    and bumps their epochs; the new owner re-seeds those shards' envs from
    (seed, shard, epoch), so training goes on instead of hanging.
  * per-actor heartbeat / status / error rows — an actor that *raises*
    reports through its error row and the learner raises ``ActorError``;
    an actor that *dies* (kill, OOM) is resharded around.

Random streams: each (shard, epoch) has its own ``torch.Generator`` seeded
from (seed, shard, epoch), which draws that shard's env states and then
every rollout in order. The reference folds a JAX key per (shard, epoch,
fragment); the two agree by outcome, not by stream.

This module is the spawn-actor entrypoint, so its import chain stays
torch-free: actors import torch in ``actor_main`` after the fork guard, and
the learner's torch use is in method bodies.
"""
from __future__ import annotations

import pickle
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from multiprocessing import get_context, shared_memory
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core import shm
from repro_torch.telemetry import span as _span
from repro_torch.telemetry import traceprop as _traceprop
from repro_torch.telemetry.procstats import (ACTOR_FIELDS, STALENESS_EDGES,
                                             StatSlab)

# fragment-slot states (one writer per state transition, like shm ctrl bytes)
SLOT_EMPTY = 0     # learner-owned: actor may claim
SLOT_WRITING = 1   # actor mid-write (reset by the learner if the actor dies)
SLOT_FULL = 2      # complete fragment; learner copies out then EMPTYs

# actor status bytes
A_BOOT = 0
A_RUN = 1
A_ERR = 2          # actor raised; error row holds the message
A_EXIT = 3         # clean exit after stop

INFO_KEYS = ("score", "episode_return", "episode_length", "valid")


class ActorError(RuntimeError):
    """An actor process raised inside its rollout loop (poisoned env or
    policy; the same failure would occur on any actor, so it propagates
    instead of triggering reassignment)."""

    def __init__(self, actor: int, op: str, message: str):
        super().__init__(f"actor {actor} failed during {op}: {message}")
        self.actor, self.op, self.message = actor, op, message


@dataclass(frozen=True)
class ReshardEvent:
    """One dead-actor recovery: which shards moved where."""
    actor: int
    shards: Tuple[int, ...]
    new_owners: Tuple[int, ...]


@dataclass(frozen=True)
class FragSpec:
    """Geometry of the shared slab, pickled into every actor."""
    num_actors: int
    num_shards: int          # disjoint env shards, assign[]-mapped to actors
    slots: int               # fragment ring depth per shard (backpressure)
    unroll: int              # T steps per fragment
    envs_per_shard: int      # E
    num_agents: int          # A (rows per env)
    obs_dim: int
    act_dim: int             # action components per agent row
    act_dtype: str           # "int32" | "float32"
    # the param leaves: ((shape, dtype name, byte offset), ...) + total size
    param_specs: Tuple[Tuple[Tuple[int, ...], str, int], ...]
    param_bytes: int
    # each leaf's key path ("enc1", "lstm/wi"), as checkpoint/ckpt names it
    param_names: Tuple[str, ...] = ()

    @property
    def rows(self) -> int:   # agent rows per fragment
        return self.envs_per_shard * self.num_agents


def itemsize(dtype: str) -> int:
    """Bytes per element of a dtype name (numpy's, or ``bfloat16``)."""
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


class AsyncLayout:
    """Byte layout of the actor–learner slab (SlabLayout idiom)."""

    def __init__(self, spec: FragSpec):
        self.spec = spec
        S, Q, T = spec.num_shards, spec.slots, spec.unroll
        R, E, N = spec.rows, spec.envs_per_shard, spec.num_actors
        shapes = {
            "stop": ((1,), np.uint8),
            "pseq": ((1,), np.int64),     # seqlock counter (odd = writing)
            "pver": ((1,), np.int64),     # published params version
            "params": ((spec.param_bytes,), np.uint8),
            "assign": ((S,), np.int32),   # shard -> owning actor
            "epoch": ((S,), np.int64),    # bumped on reassignment
            "hbeat": ((N,), np.int64),
            "astat": ((N,), np.uint8),
            "err": ((N, shm.ERR_BYTES), np.uint8),
            "fctrl": ((S, Q), np.uint8),
            "fver": ((S, Q), np.int64),   # policy version that acted
            "fseq": ((S, Q), np.int64),   # per-shard fragment counter
            "factor": ((S, Q), np.int32),
            "obs": ((S, Q, T, R, spec.obs_dim), np.float32),
            "act": ((S, Q, T, R, spec.act_dim), np.dtype(spec.act_dtype)),
            "logp": ((S, Q, T, R), np.float32),
            "val": ((S, Q, T, R), np.float32),
            "rew": ((S, Q, T, R), np.float32),
            "done": ((S, Q, T, R), np.uint8),
            "reset": ((S, Q, T, R), np.uint8),
            "i_score": ((S, Q, T, E), np.float32),
            "i_ret": ((S, Q, T, E), np.float32),
            "i_len": ((S, Q, T, E), np.int32),
            "i_valid": ((S, Q, T, E), np.uint8),
            "boot": ((S, Q, R), np.float32),   # bootstrap value rows
        }
        self.sections = {}
        end = 0
        for name, (shape, dtype) in shapes.items():
            start, end = shm._section(end, shape, dtype)
            self.sections[name] = (start, shape, dtype)
        self.nbytes = end

    def views(self, buf) -> dict:
        out = {}
        for name, (start, shape, dtype) in self.sections.items():
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = np.frombuffer(
                buf, dtype=dtype, count=n, offset=start).reshape(shape)
        return out

    def param_views(self, buf) -> list:
        """One uint8 view per param leaf: its raw bytes, in
        ``spec.param_names`` order."""
        base = self.sections["params"][0]
        return [np.frombuffer(buf, dtype=np.uint8,
                              count=int(np.prod(shape, dtype=np.int64))
                              * itemsize(dt), offset=base + off)
                for shape, dt, off in self.spec.param_specs]


def make_param_specs(leaves) -> Tuple[Tuple, int]:
    """((shape, dtype name, offset), ...) and the total bytes for the param
    leaves (tensors or numpy arrays), each offset 8-byte aligned."""
    specs, off = [], 0
    for leaf in leaves:
        dt = str(leaf.dtype).replace("torch.", "")
        shape = tuple(int(n) for n in leaf.shape)
        off = ((off + 7) // 8) * 8
        specs.append((shape, dt, off))
        off += int(np.prod(shape, dtype=np.int64)) * itemsize(dt)
    return tuple(specs), off


def read_params_seqlock(v: dict, pviews: list, spin: shm.SpinConfig,
                        srow=None):
    """Torn-read-safe copy of the published leaves' bytes: retry while the
    seqlock counter is odd (write in progress) or changed across the copy.
    ``srow`` (a telemetry ``StatRow``) counts the retries when given."""
    w = shm.SpinWait(spin)
    while True:
        s1 = int(v["pseq"][0])
        if s1 % 2 == 0:
            leaves = [pv.copy() for pv in pviews]
            ver = int(v["pver"][0])
            if int(v["pseq"][0]) == s1:
                return leaves, ver
        if srow is not None:
            srow.add("seqlock_retries")
        w.pause()


def params_from_bytes(spec: FragSpec, raw: list, device) -> dict:
    """The param dict an actor acts with: each leaf's bytes viewed as its
    dtype and shape, on ``device``, nested by its key path."""
    import torch
    out: dict = {}
    for name, (shape, dt, _off), b in zip(spec.param_names,
                                          spec.param_specs, raw):
        t = torch.from_numpy(b).view(getattr(torch, dt)).reshape(shape)
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.to(device)
    return out


def shard_seed(seed: int, shard: int, epoch: int) -> int:
    """The generator seed of one (shard, epoch): a reassigned shard restarts
    from a new, deterministic stream on its new owner."""
    return (int(seed) * 1_000_003 + 7919 * int(shard) + int(epoch)) \
        % (2 ** 63 - 1)


@dataclass(frozen=True)
class ActorConfig:
    """Everything one spawn actor needs (small and picklable)."""
    shm_name: str
    actor_id: int
    spec: FragSpec
    seed: int                # shared base seed; streams are keyed by shard
    device: str = "cpu"      # where the actor acts: the learner's device
    spin: shm.SpinConfig = field(default_factory=shm.SpinConfig)
    payload_env: bytes = b""
    payload_policy: bytes = b""
    payload_dist: bytes = b""
    jitter_ms: float = 0.0   # injected per-step latency (fault tests)
    stats: object = None     # telemetry.procstats.StatSpec | None
    trace: object = None     # telemetry.traceprop.TraceConfig | None


class Fragment(NamedTuple):
    """One copied-out rollout fragment (numpy, learner-side)."""
    shard: int
    actor: int
    version: int             # params version that produced it
    seq: int
    obs: np.ndarray          # (T, R, obs_dim)
    actions: np.ndarray      # (T, R, act_dim)
    logprobs: np.ndarray     # (T, R)
    values: np.ndarray
    rewards: np.ndarray
    dones: np.ndarray        # (T, R) bool
    resets: np.ndarray
    infos: dict              # {key: (T, E)}
    boot: np.ndarray         # (R,) bootstrap values


# =============================== actor side ==================================

def actor_main(cfg: ActorConfig) -> None:
    """Spawn-actor entrypoint: claim an EMPTY slot per owned shard, run one
    T-step rollout on ``cfg.device``, write the fragment, repeat. Params
    refresh via the seqlock whenever the published version changes;
    ownership is re-read every pass so reassignment takes effect without
    coordination."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda._is_in_bad_fork():
        # same guard as shm.worker_main: a forked child of a parent that
        # initialised CUDA cannot use it — actors must be spawned
        raise RuntimeError(
            "actor is a forked child of a process that initialised CUDA — "
            "it was forked, not spawned. AsyncRollouts must use the "
            "'spawn' start method")
    import torch
    from repro_torch.core.vector import VecEnv
    from repro_torch.rl.rollout import RolloutCarry, rollout

    spec = cfg.spec
    me = cfg.actor_id
    seg = shm.attach_untracked(cfg.shm_name)
    lay = AsyncLayout(spec)
    v = lay.views(seg.buf)
    pviews = lay.param_views(seg.buf)
    slab = srow = None
    if cfg.stats is not None:
        # lock-free per-actor stat row: steps / fragments / ring stalls /
        # seqlock retries / staleness histogram, aggregated by the learner
        slab = StatSlab.attach(cfg.stats)
        srow = slab.row(me)
    # per-process tracing: spans flush to this actor's own spans-<pid>.jsonl
    from repro_torch.telemetry.spans import CachedSpan
    tracer = None
    if cfg.trace is not None:
        tracer = _traceprop.init_worker(cfg.trace, role=f"actor-{me}")
    rollout_span = CachedSpan("actor.rollout")
    refresh_span = CachedSpan("actor.param_refresh")
    t_flush = time.monotonic()
    try:
        device = torch.device(cfg.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            # one of N + 1 processes on the host's cores: a pool of
            # intra-op threads each would oversubscribe them
            torch.set_num_threads(1)
        env = pickle.loads(cfg.payload_env)
        policy = pickle.loads(cfg.payload_policy)
        dist = pickle.loads(cfg.payload_dist)
        vec = VecEnv(env, spec.envs_per_shard)
        T, R = spec.unroll, spec.rows

        raw, pver = read_params_seqlock(v, pviews, cfg.spin, srow)
        params = params_from_bytes(spec, raw, device)
        rng = np.random.default_rng(cfg.seed * 7919 + me + 1)
        shard_state = {}      # shard -> [carry, epoch, seq, generator]
        spin = shm.SpinWait(cfg.spin)
        v["astat"][me] = A_RUN
        while not v["stop"][0]:
            v["hbeat"][me] += 1
            if srow is not None:
                # wall-clock liveness beat (idle passes beat too)
                srow.set("last_beat_ns", time.time_ns())
            produced = False
            t_pass = time.monotonic_ns()
            for s in range(spec.num_shards):
                if v["stop"][0] or int(v["assign"][s]) != me:
                    continue
                if int(v["pver"][0]) != pver:
                    with refresh_span:
                        raw, pver = read_params_seqlock(v, pviews, cfg.spin,
                                                        srow)
                        params = params_from_bytes(spec, raw, device)
                    if srow is not None:
                        srow.add("param_loads")
                ep = int(v["epoch"][s])
                st = shard_state.get(s)
                if st is None or st[1] != ep:
                    # (seed, shard, epoch)-seeded envs: a reassigned shard
                    # restarts from a deterministic stream on its new owner
                    gen = torch.Generator(device=device).manual_seed(
                        shard_seed(cfg.seed, s, ep))
                    env_state, obs = vec.init(gen)
                    carry = RolloutCarry(
                        env_state, obs, policy.initial_carry(R, device),
                        torch.zeros(R, dtype=torch.bool, device=device))
                    st = shard_state[s] = [carry, ep, 0, gen]
                slot = None
                for q in range(spec.slots):
                    if int(v["fctrl"][s, q]) == SLOT_EMPTY:
                        slot = q
                        break
                if slot is None:          # ring full: learner is behind —
                    if srow is not None:  # backpressure bounds staleness
                        srow.add("ring_full")
                    continue
                with rollout_span:   # claim → rollout → commit
                    v["fctrl"][s, slot] = SLOT_WRITING
                    carry, traj, last_value = rollout(
                        policy, params, vec.step, st[0], st[3], T, dist)
                    if cfg.jitter_ms > 0.0:
                        # emulate jitter_ms/step of host latency, ±50%
                        time.sleep(T * cfg.jitter_ms / 1e3
                                   * rng.uniform(0.5, 1.5))
                    host = lambda x: x.cpu().numpy()
                    v["obs"][s, slot] = host(traj.obs.float())
                    v["act"][s, slot] = host(traj.actions).reshape(
                        v["act"].shape[2:])
                    v["logp"][s, slot] = host(traj.logprobs.float())
                    v["val"][s, slot] = host(traj.values.float())
                    v["rew"][s, slot] = host(traj.rewards.float())
                    v["done"][s, slot] = host(traj.dones.to(torch.uint8))
                    v["reset"][s, slot] = host(traj.resets.to(torch.uint8))
                    v["i_score"][s, slot] = host(traj.infos["score"].float())
                    v["i_ret"][s, slot] = host(
                        traj.infos["episode_return"].float())
                    v["i_len"][s, slot] = host(
                        traj.infos["episode_length"].int())
                    v["i_valid"][s, slot] = host(
                        traj.infos["valid"].to(torch.uint8))
                    v["boot"][s, slot] = host(last_value.float())
                    v["fver"][s, slot] = pver
                    v["fseq"][s, slot] = st[2]
                    v["factor"][s, slot] = me
                    st[0], st[2] = carry, st[2] + 1
                    v["fctrl"][s, slot] = SLOT_FULL  # commit (written last)
                produced = True
                if srow is not None:
                    srow.add("fragments")
                    srow.add("steps", T * R)
                    # learner-updates-behind at commit time
                    srow.observe(int(v["pver"][0]) - pver)
            if srow is not None:
                srow.add("busy_ns" if produced else "wait_ns",
                         time.monotonic_ns() - t_pass)
            if produced:
                spin.reset()
            else:
                spin.pause()
            if tracer is not None and time.monotonic() - t_flush > 0.25:
                tracer.flush()
                t_flush = time.monotonic()
        v["astat"][me] = A_EXIT
    except Exception as e:    # noqa: BLE001 — forwarded to the learner
        shm._write_error(v, me, "step", e)
        v["astat"][me] = A_ERR
        if srow is not None:
            srow.add("errors")
    finally:
        if tracer is not None:
            try:
                tracer.flush()
            except Exception:
                pass
        del v, pviews, srow
        seg.close()
        if slab is not None:
            slab.close()


# =============================== learner side ================================

class AsyncRollouts:
    """Learner-side handle: owns the slab, the actor processes, the param
    broadcast, and dead-actor/straggler monitoring. ``device`` is where the
    actors act (the learner's device)."""

    def __init__(self, env, policy, dist, tcfg, *, params0, seed: int,
                 device="cpu", jitter_ms: float = None,
                 spin: shm.SpinConfig = None):
        from repro_torch.checkpoint.ckpt import _flatten_with_names
        from repro_torch.distributed.fault import StragglerMonitor

        N = tcfg.num_actors
        S = N * tcfg.shards_per_actor
        if N < 1:
            raise ValueError(f"num_actors must be >= 1, got {N}")
        if tcfg.num_envs % S:
            raise ValueError(
                f"num_envs={tcfg.num_envs} not divisible by num_shards={S} "
                f"(num_actors={N} × shards_per_actor="
                f"{tcfg.shards_per_actor})")
        if policy.recurrent:
            raise ValueError(
                "the async tier does not ship recurrent carries through the "
                "fragment slab; use the jit/host tiers for LSTM policies")
        A = getattr(env, "num_agents", 1)
        named = _flatten_with_names(params0)
        pspecs, pbytes = make_param_specs([leaf for _, leaf in named])
        self.spec = FragSpec(
            num_actors=N, num_shards=S, slots=max(1, tcfg.actor_slots),
            unroll=tcfg.unroll_length, envs_per_shard=tcfg.num_envs // S,
            num_agents=A, obs_dim=policy.obs_dim,
            act_dim=dist.action_dim, act_dtype=dist.action_dtype,
            param_specs=pspecs, param_bytes=pbytes,
            param_names=tuple(name for name, _ in named))
        self.layout = AsyncLayout(self.spec)
        self.spin = spin or shm.default_spin(workers=N + 1)
        self.device = str(device)
        jitter = tcfg.actor_jitter_ms if jitter_ms is None else jitter_ms

        self._seg = shared_memory.SharedMemory(
            create=True, size=self.layout.nbytes)
        self._v = self.layout.views(self._seg.buf)
        self._pviews = self.layout.param_views(self._seg.buf)
        self._v["assign"][:] = np.arange(S, dtype=np.int32) % N
        self._v["pver"][0] = -1
        self.publish(params0, 0)

        self._fifo = deque()
        self._dead = set()
        self.events = []
        self._monitors = [StragglerMonitor(window=16, min_samples=4)
                          for _ in range(N)]
        self._last_arrival = [None] * N
        self.straggler_flags = [0] * N
        self._last_liveness = 0.0

        env_p = shm.dumps_env_fn(env)
        pol_p = shm.dumps_env_fn(policy)
        dist_p = shm.dumps_env_fn(dist)
        # per-actor telemetry rows (separate tiny segment, learner-owned):
        # written lock-free by actors, aggregated in stats() — and readable
        # for dead actors, whose rows freeze at their last write
        self._stats_slab = StatSlab.create(N, ACTOR_FIELDS, STALENESS_EDGES)
        trace_cfg = _traceprop.current()
        ctx = get_context("spawn")
        self._procs = []
        try:
            with _span("async.spawn"):
                for a in range(N):
                    p = ctx.Process(
                        target=actor_main,
                        args=(ActorConfig(
                            shm_name=self._seg.name, actor_id=a,
                            spec=self.spec, seed=seed, device=self.device,
                            spin=self.spin, payload_env=env_p,
                            payload_policy=pol_p, payload_dist=dist_p,
                            jitter_ms=jitter, stats=self._stats_slab.spec,
                            trace=trace_cfg),),
                        daemon=True, name=f"repro-torch-actor-{a}")
                    p.start()
                    self._procs.append(p)
        except Exception:
            self.close()
            raise

    # -- param broadcast -------------------------------------------------------
    def publish(self, params, version: int) -> None:
        """Seqlock-publish new params. Every leaf is copied to the host as
        raw bytes *before* the lock window opens, so a poisoned update (a
        device error surfaces at that copy) raises here without touching
        the slab — actors keep acting on the previous version."""
        import torch
        from repro_torch.checkpoint.ckpt import _flatten_with_names
        host = [leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                .cpu().numpy() for _, leaf in _flatten_with_names(params)]
        with _span("async.publish"):
            v = self._v
            v["pseq"][0] += 1          # odd: readers retry
            for dst, src in zip(self._pviews, host):
                np.copyto(dst, src)
            v["pver"][0] = version
            v["pseq"][0] += 1          # even: committed
            self.version = version

    # -- fragment harvest ------------------------------------------------------
    def poll(self) -> int:
        """Copy out every FULL slot (ordered by per-shard sequence number)
        into the FIFO; returns how many arrived. Also surfaces actor
        errors."""
        v = self._v
        self._check_errors()
        found = []
        S, Q = self.spec.num_shards, self.spec.slots
        for s in range(S):
            for q in range(Q):
                if int(v["fctrl"][s, q]) == SLOT_FULL:
                    found.append((int(v["fseq"][s, q]), s, q))
        found.sort()
        now = time.monotonic()
        for seq, s, q in found:
            actor = int(v["factor"][s, q])
            frag = Fragment(
                shard=s, actor=actor, version=int(v["fver"][s, q]), seq=seq,
                obs=v["obs"][s, q].copy(),
                actions=v["act"][s, q].copy(),
                logprobs=v["logp"][s, q].copy(),
                values=v["val"][s, q].copy(),
                rewards=v["rew"][s, q].copy(),
                dones=v["done"][s, q].astype(bool),
                resets=v["reset"][s, q].astype(bool),
                infos={"score": v["i_score"][s, q].copy(),
                       "episode_return": v["i_ret"][s, q].copy(),
                       "episode_length": v["i_len"][s, q].copy(),
                       "valid": v["i_valid"][s, q].astype(bool)},
                boot=v["boot"][s, q].copy())
            v["fctrl"][s, q] = SLOT_EMPTY         # hand the slot back
            self._fifo.append(frag)
            if 0 <= actor < self.spec.num_actors:
                last = self._last_arrival[actor]
                if last is not None:
                    if self._monitors[actor].record(now - last):
                        self.straggler_flags[actor] += 1
                self._last_arrival[actor] = now
        return len(found)

    def wait_fragments(self, n: int, *, timeout: float) -> list:
        """Block (spin ladder) until ``n`` fragments are buffered; FIFO
        order. Dead actors are found and resharded *while waiting*, so a
        kill never hangs the learner — only a fragment-less ``timeout``
        raises."""
        deadline = time.monotonic() + timeout
        w = shm.SpinWait(self.spin)
        # liveness is checked once per call unconditionally: a fast
        # surviving actor that keeps the FIFO full must not mask a dead
        # peer; the throttle below only bounds waitpid traffic in the loop
        self._check_actors()
        self._last_liveness = time.monotonic()
        with _span("async.wait_fragments"):
            while True:
                if self.poll():
                    w.reset()
                now = time.monotonic()
                if now - self._last_liveness > 0.05:
                    self._last_liveness = now
                    self._check_actors()
                if len(self._fifo) >= n:
                    return [self._fifo.popleft() for _ in range(n)]
                if now > deadline:
                    raise TimeoutError(
                        f"async tier: {n} fragment(s) not produced within "
                        f"{timeout}s (have {len(self._fifo)}; alive="
                        f"{self.alive_actors()}, assign="
                        f"{self._v['assign'].tolist()})")
                w.pause()

    # -- fault handling --------------------------------------------------------
    def _check_errors(self) -> None:
        for a in range(self.spec.num_actors):
            if int(self._v["astat"][a]) == A_ERR and a not in self._dead:
                self._dead.add(a)
                op, msg = shm.read_error(self._v, a)
                raise ActorError(a, op, msg)

    def _check_actors(self) -> None:
        """A process that is gone without a clean EXIT status is dead:
        harvest nothing from it, reset its half-written slots, and reassign
        its shards to the least-loaded survivors."""
        stopping = bool(self._v["stop"][0])
        for a, p in enumerate(self._procs):
            if a in self._dead or p.is_alive():
                continue
            if stopping and int(self._v["astat"][a]) == A_EXIT:
                continue
            self._dead.add(a)
            self._reshard(a)

    def _reshard(self, dead: int) -> None:
        survivors = [b for b in range(self.spec.num_actors)
                     if b not in self._dead]
        if not survivors:
            # raised before binding any slab view locally: a view captured
            # in this traceback would pin the buffer and break close()
            raise RuntimeError(
                f"all {self.spec.num_actors} actors are dead (last: actor "
                f"{dead}); nothing left to reassign shards to")
        v = self._v
        loads = {b: int(np.sum(np.asarray(v["assign"]) == b))
                 for b in survivors}
        moved, owners = [], []
        for s in range(self.spec.num_shards):
            if int(v["assign"][s]) != dead:
                continue
            b = min(survivors, key=lambda x: (loads[x], x))
            loads[b] += 1
            for q in range(self.spec.slots):
                # the dead writer's half-written slot is garbage; FULL slots
                # were committed before death and stay consumable
                if int(v["fctrl"][s, q]) == SLOT_WRITING:
                    v["fctrl"][s, q] = SLOT_EMPTY
            v["epoch"][s] += 1         # new owner re-seeds (shard, epoch)
            v["assign"][s] = b         # ownership handoff (written last)
            moved.append(s)
            owners.append(b)
        self.events.append(ReshardEvent(actor=dead, shards=tuple(moved),
                                        new_owners=tuple(owners)))

    # -- introspection ---------------------------------------------------------
    def alive_actors(self) -> list:
        return [a for a, p in enumerate(self._procs)
                if a not in self._dead and p.is_alive()]

    def liveness(self) -> dict:
        """Per-actor liveness: wall-clock ``last_beat_ns`` from the stat
        slab (actors beat every pass, idle ones too) plus dead detection
        that does not wait for the learner's next ``wait_fragments``."""
        beats = []
        slab = getattr(self, "_stats_slab", None)
        if slab is not None and slab.counters is not None:
            col = slab.spec.fields.index("last_beat_ns")
            beats = [int(b) for b in slab.counters[:, col]]
        v = getattr(self, "_v", None)
        dead = set(self._dead)
        stopping = v is None or bool(v["stop"][0])
        for a, p in enumerate(self._procs):
            if p.is_alive():
                continue
            if stopping and (v is None or int(v["astat"][a]) == A_EXIT):
                continue                # clean shutdown, not a death
            dead.add(a)
        return {"now_ns": time.time_ns(),
                "workers": self.spec.num_actors,
                "last_beat_ns": beats, "dead": sorted(dead)}

    def stats(self) -> dict:
        out = {
            "assign": self._v["assign"].tolist(),
            "epoch": self._v["epoch"].tolist(),
            "heartbeats": self._v["hbeat"].tolist(),
            "dead": sorted(self._dead),
            "straggler_flags": list(self.straggler_flags),
            "reshards": len(self.events),
            "liveness": self.liveness(),
            "devices": [self.device] * self.spec.num_actors,
            # staleness age per actor: seconds since its last fragment
            # arrived (None before the first one) + the monitor medians
            "stragglers": [m.stats() for m in self._monitors],
        }
        if self._stats_slab is not None:
            # per-actor shared-memory rows: steps, fragments, ring stalls,
            # seqlock retries and the staleness histogram. Dead actors'
            # rows stay readable (learner-owned segment).
            out["actors"] = self._stats_slab.aggregate()
        return out

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if getattr(self, "_seg", None) is None:
            return
        self._v["stop"][0] = 1
        shm.spin_until(
            lambda: all(not p.is_alive() for p in self._procs),
            self.spin, timeout=10.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5.0)
        if getattr(self, "_stats_slab", None) is not None:
            self._stats_slab.close()
            self._stats_slab = None
        del self._v, self._pviews
        try:
            self._seg.close()
        except BufferError:
            # a propagating exception's traceback frames can still pin slab
            # views; the segment is unlinked below regardless and the
            # mapping goes with the process
            pass
        try:
            self._seg.unlink()
        except FileNotFoundError:
            pass
        self._seg = None


def stack_fragments(frags: list):
    """n fragments → one (T, n·R)-batched numpy Trajectory + bootstrap row:
    the async twin of TrainEngine._stack_fragments (fragments arrive
    time-major, so this is concatenation along the batch axis)."""
    from repro_torch.rl.rollout import Trajectory
    cat = lambda key: np.concatenate([getattr(f, key) for f in frags],
                                     axis=1)
    infos = {k: np.concatenate([f.infos[k] for f in frags], axis=1)
             for k in INFO_KEYS}
    traj = Trajectory(
        obs=cat("obs"), actions=cat("actions"), logprobs=cat("logprobs"),
        values=cat("values"), rewards=cat("rewards"), dones=cat("dones"),
        resets=cat("resets"), infos=infos)
    last_value = np.concatenate([f.boot for f in frags])
    return traj, last_value
