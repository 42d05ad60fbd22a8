"""Host-environment pool — the paper's Python EnvPool, faithfully.

The counterpart of ``repro/core/host.py``. The device pool (core/pool.py)
covers the batched torch envs. Real
deployments also wrap *host* environments (NetHack, Pokémon Red — stateful
Python/C processes). This module reproduces the paper's mechanism for those:
simulate M envs on workers, return batches of N ≪ M from the **first
finishers**, so the learner never waits on stragglers and env stepping
overlaps policy compute. M = 2N ⇒ double buffering (paper §3.3).

Two execution backends share one protocol:

  * ``backend="thread"`` (default) — worker threads. Right when env steps
    block in C or sleep on I/O and therefore release the GIL (NLE/Atari-style
    steps); cheapest startup, picklability never matters.
  * ``backend="proc"`` — spawn worker processes over per-pool shared-memory
    slabs (``core/shm.py``) with busy-wait ready flags, the paper's
    multiprocessing design. Pure-Python stepping serializes on the GIL under
    threads; processes actually parallelize it (on a box with the cores
    for them; on a single core the gap collapses). Zero pickled bytes cross
    per step: workers read actions from and write observations into the
    slab rows.

Protocol guarantees (what the bridge/engine layers above rely on, identical
under both backends):

  * autoreset — a worker resets its env in-worker on ``done``; the batch row
    carries the *terminal* step's reward/done/info and the *next* episode's
    first observation, exactly like the device ``VecEnv`` autoreset path.
  * seeding — episode ``e`` of env ``i`` resets with ``seed + i + M * e``, a
    deterministic per-env seed sequence (the old ``env.reset(None)`` made
    every post-crash episode nondeterministic).
  * terminal info — ``recv`` surfaces fixed-shape episode stats
    (``score`` / ``episode_return`` / ``episode_length`` / ``valid`` with
    ``valid == done``) accumulated per env, matching ``core/pool.empty_info``.
  * crash propagation — an exception in ``reset``/``step`` is forwarded as a
    ``HostEnvError`` raised from ``recv()`` (naming the env and op), never a
    silently dead worker with ``recv()`` blocked forever; ``recv(timeout=)``
    additionally bounds the wait on healthy-but-slow workers, and ``send``
    refuses to queue onto a dead worker instead of deadlocking.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.core import shm as _shm
from repro_torch.telemetry import span as _span
from repro_torch.telemetry import traceprop as _traceprop
from repro_torch.telemetry.procstats import HOST_FIELDS, StatSlab


class HostEnv:
    """Stateful host env: numpy in/out. Subclass or duck-type."""

    def reset(self, seed: int):                 # -> obs
        raise NotImplementedError

    def step(self, action):                     # -> (obs, rew, done, info)
        raise NotImplementedError


class RemoteEnvError(RuntimeError):
    """A worker-process exception, reconstructed from its shm error row.

    The original traceback lives in the (dead) worker; ``str()`` carries the
    worker-side ``"ExcType: message"`` text."""


class HostEnvError(RuntimeError):
    """A worker env raised; re-raised on the consumer thread by ``recv``."""

    def __init__(self, env_index: int, op: str, cause: BaseException):
        # RemoteEnvError text already reads "ExcType: message" — don't
        # double-prefix it with its own class name
        detail = (str(cause) if isinstance(cause, RemoteEnvError)
                  else f"{type(cause).__name__}: {cause}")
        super().__init__(f"host env {env_index} raised in {op}: {detail}")
        self.env_index = env_index
        self.op = op


class _WorkerFailure:
    """Ready-queue sentinel carrying a worker exception to recv()."""

    def __init__(self, env_index: int, op: str, exc: BaseException):
        self.env_index, self.op, self.exc = env_index, op, exc


# "no timeout argument given" marker: distinguishes recv() (use the pool's
# default) from recv(timeout=None) (explicitly wait forever)
_UNSET = object()

# unlinked-but-unclosable segments (a view was pinned by a caller-held
# traceback at close time); held so their finalizer never retries close
_LEAKED_SEGS: list = []


class HostPool:
    """EnvPool semantics over host envs.

    recv()  -> (obs (N, …), rew (N, …), done (N,), info, env_ids (N,))
    send(actions, env_ids)

    ``info`` is a dict of per-env arrays — ``score`` (f32), ``episode_return``
    (f32), ``episode_length`` (i32), ``valid`` (bool) — nonzero exactly on the
    rows whose episode ended this step (``valid == done``). ``score`` is taken
    from the env's terminal step info dict (key ``"score"``) when present.

    Batch rows are sorted by env index, so with num_envs == batch_size the
    pool degrades to *deterministic* synchronous vectorization (wait for
    everyone, rows always 0..M-1) — the paper's baseline.

    ``backend="proc"`` dispatches construction to :class:`ProcHostPool`
    (same API; requires a picklable ``env_fns`` and a ``slab`` row spec).
    ``rew_shape`` is the per-env reward row shape — ``()`` scalar,
    ``(num_agents,)`` multi-agent; when omitted it is inferred from the
    widest-rank reward seen in a batch (rank, not lexicographic order).
    """

    def __init__(self, env_fns: Sequence[Callable[[], HostEnv]],
                 batch_size: int, seed: int = 0,
                 recv_timeout: float = None, *, backend: str = "thread",
                 rew_shape: tuple = None, slab: "_shm.SlabSpec" = None,
                 spin: "_shm.SpinConfig" = None):
        assert backend == "thread", backend     # "proc" dispatched by __new__
        self.M = len(env_fns)
        self.N = batch_size
        assert 1 <= self.N <= self.M
        self.seed = seed
        self.recv_timeout = recv_timeout
        self.rew_shape = None if rew_shape is None else tuple(rew_shape)
        self._envs: List[HostEnv] = [fn() for fn in env_fns]
        self._ready: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._inboxes: List["queue.Queue"] = [queue.Queue(1)
                                              for _ in range(self.M)]
        self._stop = False
        self._closed = False
        # episode-stat accumulators (touched only by the recv thread; every
        # ready item passes through recv exactly once, in per-env order)
        self._ep_return = np.zeros((self.M,), np.float64)
        self._ep_length = np.zeros((self.M,), np.int64)
        self._stat_steps = 0
        self._stat_episodes = 0
        self._stat_recvs = 0
        # wall-clock liveness beats, one per worker (written by the worker
        # thread, read by liveness()/healthz — int64 stores are atomic)
        self._beat_ns = np.zeros((self.M,), np.int64)
        for i, env in enumerate(self._envs):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True)
            t.start()
            self._threads.append(t)
        for i in range(self.M):                 # initial resets (episode 0)
            self._inboxes[i].put(("reset", seed + i))

    def __new__(cls, env_fns=None, batch_size=None, seed=0,
                recv_timeout=None, *, backend="thread", **kw):
        # Backend dispatch at the public constructor: HostPool(...,
        # backend="proc") builds a ProcHostPool (type.__call__ then runs
        # type(obj).__init__, i.e. ProcHostPool.__init__, with these args).
        if cls is HostPool and backend == "proc":
            return super().__new__(ProcHostPool)
        return super().__new__(cls)

    def _worker(self, i: int):
        env = self._envs[i]
        episode = 0
        op = "reset"
        try:
            while not self._stop:
                self._beat_ns[i] = time.time_ns()
                try:
                    # poll, don't park: an untimed get() here kept the
                    # worker alive forever when the close sentinel was
                    # dropped (full inbox) — _stop must win on its own
                    cmd, arg = self._inboxes[i].get(timeout=0.05)
                except queue.Empty:
                    continue
                if cmd == "close" or self._stop:
                    return
                if cmd == "reset":
                    op = "reset"
                    obs = env.reset(arg)
                    self._ready.put((i, obs, 0.0, False, None, False))
                else:
                    op = "step"
                    obs, rew, done, info = env.step(arg)
                    if done:
                        # deterministic per-env seed sequence: episode e of
                        # env i resets with seed + i + M*e
                        episode += 1
                        op = "reset"
                        obs = env.reset(self.seed + i + self.M * episode)
                    self._ready.put((i, obs, rew, done, info, True))
        except Exception as e:   # noqa: BLE001 — forwarded, never swallowed
            self._ready.put(_WorkerFailure(i, op, e))

    def recv(self, timeout: float = _UNSET):
        """Block until the N first-finished envs have observations.

        Raises ``HostEnvError`` if any of those envs crashed, and
        ``TimeoutError`` if fewer than N envs produce a result within
        ``timeout`` seconds. Defaults to the pool's ``recv_timeout``
        (constructor arg); pass ``timeout=None`` to explicitly opt into
        waiting forever."""
        if timeout is _UNSET:
            timeout = self.recv_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        items = []
        with _span("host.recv"):
            for _ in range(self.N):
                try:
                    if deadline is None:
                        # explicit timeout=None: a deliberate wait-forever
                        it = self._ready.get()  # repro_torch: noqa[BLOCKING-NO-TIMEOUT] — the caller passed timeout=None
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise queue.Empty
                        it = self._ready.get(timeout=remaining)
                except queue.Empty:
                    raise TimeoutError(
                        f"HostPool.recv timed out after {timeout}s with "
                        f"{len(items)}/{self.N} envs ready (slow or "
                        f"deadlocked worker?)") from None
                if isinstance(it, _WorkerFailure):
                    raise HostEnvError(it.env_index, it.op,
                                       it.exc) from it.exc
                items.append(it)
        return self._assemble(items)

    def _assemble(self, items):
        """Batch (i, obs, rew, done, raw_info, is_step) items — shared by
        both backends so row layout/dtypes/info stay bitwise-identical."""
        items.sort(key=lambda it: it[0])        # deterministic row layout
        ids = np.asarray([it[0] for it in items])
        obs = np.stack([np.asarray(it[1]) for it in items])
        # initial-reset rows carry scalar 0.0 rewards; broadcast them to the
        # step-reward shape (per-agent vectors for multi-agent envs)
        rews = [np.asarray(it[2], np.float32) for it in items]
        shp = self.rew_shape
        if shp is None:
            # fall back to the widest-RANK reward in the batch. (A plain
            # max() over shapes compares lexicographically — between (2,)
            # and (10,) it picks (2,) and the stack breaks for mixed-rank
            # batches; the pool's declared rew_shape is authoritative.)
            shp = max((r.shape for r in rews), key=len, default=())
        rew = np.stack([np.broadcast_to(r, shp) for r in rews])
        done = np.asarray([it[3] for it in items], bool)
        info = self._episode_stats(items)
        return obs, rew, done, info, ids

    def _episode_stats(self, items) -> dict:
        """Fold this batch into the per-env accumulators and emit the
        fixed-shape terminal-info rows (valid == done)."""
        n = len(items)
        self._stat_recvs += 1
        score = np.zeros((n,), np.float32)
        ep_ret = np.zeros((n,), np.float32)
        ep_len = np.zeros((n,), np.int32)
        valid = np.zeros((n,), bool)
        for j, (i, _obs, rew, done, raw, is_step) in enumerate(items):
            if not is_step:
                continue                        # initial reset: not a step
            self._ep_return[i] += float(np.sum(rew))
            self._ep_length[i] += 1
            self._stat_steps += 1
            if done:
                self._stat_episodes += 1
                valid[j] = True
                ep_ret[j] = self._ep_return[i]
                ep_len[j] = self._ep_length[i]
                if raw:
                    score[j] = float(raw.get("score", 0.0))
                self._ep_return[i] = 0.0
                self._ep_length[i] = 0
        return {"score": score, "episode_return": ep_ret,
                "episode_length": ep_len, "valid": valid}

    def send(self, actions, env_ids):
        """Queue one step per env. Bounded: an unbounded ``put`` on the
        size-1 inbox of a worker that died mid-step blocked forever; now the
        put re-checks worker liveness and raises ``HostEnvError`` instead."""
        with _span("host.send"):
            for a, i in zip(np.asarray(actions), env_ids):
                i = int(i)
                while True:
                    try:
                        self._inboxes[i].put(("step", a), timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop:
                            return              # pool is closing; drop
                        if not self._threads[i].is_alive():
                            raise HostEnvError(i, "send", RuntimeError(
                                "worker thread is dead and its inbox is "
                                "full; command undeliverable")) from None

    def liveness(self) -> dict:
        """Per-worker liveness for /healthz: wall-clock beats (ns) plus the
        set of workers known dead. ``last_beat_ns == 0`` means "not booted
        yet" — the consumer treats that as booting, not dead."""
        dead = [] if self._stop else [
            i for i, t in enumerate(self._threads) if not t.is_alive()]
        return {"now_ns": time.time_ns(), "workers": self.M,
                "last_beat_ns": [int(b) for b in self._beat_ns],
                "dead": dead}

    def stats(self) -> dict:
        """Parent-side pool counters (both backends; the proc backend adds
        the per-worker shared-memory stat rows on top)."""
        return {"backend": "thread", "workers": self.M,
                "steps": int(self._stat_steps),
                "episodes": int(self._stat_episodes),
                "recv_batches": int(self._stat_recvs),
                "liveness": self.liveness()}

    def close(self, timeout: float = 5.0):
        """Stop workers and join them. Drains each inbox before posting the
        close sentinel so a worker blocked in ``queue.get`` always receives
        it (the old ``put_nowait`` on a full Queue(1) was silently skipped,
        leaving the worker blocked forever)."""
        if self._closed:
            return
        self._closed = True
        self._stop = True
        for i in range(self.M):
            for _ in range(2):                  # drain, then post (bounded)
                try:
                    self._inboxes[i].put_nowait(("close", None))
                    break
                except queue.Full:
                    try:
                        self._inboxes[i].get_nowait()
                    except queue.Empty:
                        pass
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


class ProcHostPool(HostPool):
    """``backend="proc"``: spawn worker processes + shared-memory slabs.

    Each env gets a row in one per-pool ``SharedMemory`` segment (layout:
    ``core/shm.SlabLayout``). The parent writes actions/seeds into the rows
    and flips the env's ctrl byte to CMD_*; the worker steps the env
    in-process, writes obs/rew/done/episode-stat fields back into the rows
    and flips the byte to READY. Both sides wait on the byte with the
    spin → sched_yield → sleep ladder; nothing is pickled after startup.

    Requirements beyond the thread backend: ``env_fns`` must pickle (spawn
    context — module-level classes / ``functools.partial``; see
    ``shm.dumps_env_fn``) and ``slab`` (a ``shm.SlabSpec``) must describe
    the per-env obs/action/reward rows. Harvested-but-undelivered results
    are buffered FIFO across ``recv`` calls, which also keeps first-finisher
    batches fair (a pure index scan would starve high-index envs).
    """

    def __init__(self, env_fns: Sequence[Callable[[], HostEnv]],
                 batch_size: int, seed: int = 0,
                 recv_timeout: float = None, *, backend: str = "proc",
                 rew_shape: tuple = None, slab: "_shm.SlabSpec" = None,
                 spin: "_shm.SpinConfig" = None):
        assert backend == "proc", backend
        if slab is None:
            raise ValueError(
                "backend='proc' needs slab=shm.SlabSpec(obs_shape, "
                "act_shape, ...) to size the shared-memory rows")
        self.M = len(env_fns)
        self.N = batch_size
        assert 1 <= self.N <= self.M
        self.seed = seed
        self.recv_timeout = recv_timeout
        self.slab = slab
        self.spin = spin or _shm.default_spin(workers=self.M)
        self.rew_shape = (tuple(slab.rew_shape) if rew_shape is None
                          else tuple(rew_shape))
        self._closed = False
        self._ep_return = np.zeros((self.M,), np.float64)
        self._ep_length = np.zeros((self.M,), np.int64)
        self._stat_steps = 0
        self._stat_episodes = 0
        self._stat_recvs = 0
        payloads = [_shm.dumps_env_fn(fn) for fn in env_fns]  # fail fast
        self._layout = _shm.SlabLayout(slab, self.M)
        from multiprocessing import get_context, shared_memory
        self._seg = shared_memory.SharedMemory(
            create=True, size=self._layout.nbytes)
        self._v = self._layout.views(self._seg.buf)
        self._v["ctrl"][:] = _shm.IDLE
        self._v["stop"][0] = 0
        # initial resets (episode 0): command rows first, then spawn
        self._v["seed"][:] = seed + np.arange(self.M, dtype=np.int64)
        self._v["ctrl"][:] = _shm.CMD_RESET
        self._out = set(range(self.M))          # env ids with commands queued
        self._fifo: List[tuple] = []            # harvested, undelivered items
        # per-worker telemetry rows: workers write lock-free into their own
        # row of a second (tiny) segment; the parent aggregates with one
        # vectorized sum and zero pickling (telemetry.procstats)
        self._stats_slab = StatSlab.create(self.M, HOST_FIELDS)
        ctx = get_context("spawn")              # never fork: CUDA parent
        self._procs = []
        # cross-process trace propagation: when the parent has tracing on
        # with a run dir, ship a TraceConfig so each worker flushes its own
        # spans-<pid>.jsonl into the same run (None otherwise — free)
        trace_cfg = _traceprop.current()
        with _span("host.spawn"):
            for i in range(self.M):
                cfg = _shm.WorkerConfig(
                    shm_name=self._seg.name, index=i, M=self.M, seed=seed,
                    spec=slab, spin=self.spin, payload=payloads[i],
                    stats=self._stats_slab.spec, trace=trace_cfg)
                p = ctx.Process(target=_shm.worker_main, args=(cfg,),
                                daemon=True)
                p.start()
                self._procs.append(p)

    # -- harvesting ---------------------------------------------------------

    def _raise_error(self, i: int):
        op, msg = _shm.read_error(self._v, i)
        err = RemoteEnvError(msg)
        raise HostEnvError(i, op, err) from err

    def _harvest_ready(self) -> bool:
        """Copy every READY env's rows into the FIFO; raise on ERROR.

        No slab view may live in a local when an exception leaves this
        frame — the traceback would pin the numpy buffer export and
        ``close()``'s ``seg.close()`` would hit BufferError. Views stay
        inside ``self._v`` (released by close) and raising is deferred
        until the loop locals are dropped."""
        got = False
        err_i = -1
        v = self._v
        for i in range(self.M):
            st = int(v["ctrl"][i])
            if st == _shm.ERROR:
                err_i = i
                break
            if st != _shm.READY:
                continue
            item = (i,
                    v["obs"][i].copy(),
                    v["rew"][i].copy(),
                    bool(v["done"][i]),
                    {"score": float(v["score"][i])} if v["meta"][i, 1]
                    else None,
                    bool(v["meta"][i, 0]))
            v["ctrl"][i] = _shm.IDLE            # row copied; slot reusable
            self._out.discard(i)
            self._fifo.append(item)
            got = True
        del v
        if err_i >= 0:
            self._out.discard(err_i)
            self._raise_error(err_i)
        return got

    def _check_liveness(self):
        for i in sorted(self._out):
            st = int(self._v["ctrl"][i])
            if st in (_shm.READY, _shm.ERROR):
                continue                        # result landed; not stuck
            p = self._procs[i]
            if not p.is_alive():
                self._out.discard(i)
                err = RemoteEnvError(
                    f"worker process died without reporting (exitcode "
                    f"{p.exitcode})")
                raise HostEnvError(i, "step", err) from err

    def recv(self, timeout: float = _UNSET):
        """First-finisher batch of N envs (FIFO over harvested results).

        Same contract as the thread backend: ``HostEnvError`` on env crash
        (including a worker process dying without reporting), ``TimeoutError``
        when fewer than N envs finish in ``timeout`` seconds."""
        if timeout is _UNSET:
            timeout = self.recv_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        wait = _shm.SpinWait(self.spin)
        with _span("host.recv"):
            while len(self._fifo) < self.N:
                if self._harvest_ready():
                    wait.reset()
                    continue
                self._check_liveness()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"HostPool.recv timed out after {timeout}s with "
                        f"{len(self._fifo)}/{self.N} envs ready (slow or "
                        f"deadlocked worker?)")
                wait.pause()
            items = self._fifo[:self.N]
            del self._fifo[:self.N]
        return self._assemble(items)

    def send(self, actions, env_ids):
        """Write action rows and flip ctrl to CMD_STEP. Refuses (with
        ``HostEnvError``) to command a dead or errored worker — the proc
        analogue of the bounded-put liveness check."""
        acts = np.asarray(actions)
        with _span("host.send"):
            self._send_rows(acts, env_ids)

    def _send_rows(self, acts, env_ids):
        for a, i in zip(acts, env_ids):
            i = int(i)
            st = int(self._v["ctrl"][i])        # no view locals: see harvest
            if st == _shm.ERROR:
                self._out.discard(i)
                self._raise_error(i)
            if not self._procs[i].is_alive():
                err = RemoteEnvError(
                    f"worker process is dead (exitcode "
                    f"{self._procs[i].exitcode}); command undeliverable")
                raise HostEnvError(i, "send", err) from err
            if st != _shm.IDLE:
                raise RuntimeError(
                    f"send to env {i} whose ctrl slot is {st} (double send "
                    f"without recv?)")
            self._v["act"][i] = np.asarray(
                a, self._v["act"].dtype).reshape(self.slab.act_shape)
            self._out.add(i)
            self._v["ctrl"][i] = _shm.CMD_STEP

    def liveness(self) -> dict:
        """Per-worker liveness from the shared-memory ``last_beat_ns`` rows
        (wall clock, written by workers even while idle) plus dead-process
        detection — /healthz tells "slow" from "dead" without waiting for a
        recv timeout."""
        beats = []
        slab = self._stats_slab
        if slab is not None and slab.counters is not None:
            col = slab.spec.fields.index("last_beat_ns")
            beats = [int(b) for b in slab.counters[:, col]]
        dead = [] if self._closed else [
            i for i, p in enumerate(self._procs) if not p.is_alive()]
        return {"now_ns": time.time_ns(), "workers": self.M,
                "last_beat_ns": beats, "dead": dead}

    def stats(self) -> dict:
        """Parent counters + the per-worker shared-memory stat rows
        (steps / resets / errors / wait_ns / busy_ns / last_beat_ns),
        aggregated with zero pickling. Readable even after workers die —
        the rows live in the parent-owned segment."""
        out = super().stats()
        out["backend"] = "proc"
        if self._stats_slab is not None:
            out["workers_detail"] = self._stats_slab.aggregate()
        return out

    def close(self, timeout: float = 5.0):
        """Raise the stop byte, join workers, terminate stragglers, unlink
        the segment. Unlike threads, a worker stuck in a long env.step is
        *actually killed* — close() is bounded even mid-step."""
        if self._closed:
            return
        self._closed = True
        self._v["stop"][0] = 1
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        if self._stats_slab is not None:
            self._stats_slab.close()
            self._stats_slab = None
        self._v = None                          # drop views before close()
        try:
            self._seg.close()
        except BufferError:
            # a caller-held traceback still pins a slab view; unlink anyway
            # (frees the name; the mapping dies with the process). Keep the
            # object alive so its finalizer doesn't retry close() at gc.
            _LEAKED_SEGS.append(self._seg)
        try:
            self._seg.unlink()
        except FileNotFoundError:
            pass

    def __del__(self):
        try:
            if not getattr(self, "_closed", True):
                self.close(timeout=0.5)
        except Exception:
            pass
