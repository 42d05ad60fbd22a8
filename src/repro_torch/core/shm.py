"""Shared-memory slabs + busy-wait signalling for the process HostPool.

This is the paper's process-based vectorization substrate: one
``multiprocessing.shared_memory`` segment per pool, carved into per-env rows
for observations / actions / rewards / done / episode-stat fields, plus a
one-byte control slot per env that parent and worker flip as a two-party
handshake. The hot path moves **zero pickled bytes** — the worker packs
observations (``np_emulate_obs``) and unpacks actions straight in the slab
rows, and the only thing that "crosses" per step is the env's control byte
changing state.

Control protocol (single writer per state, so no locks):

    parent writes when ctrl[i] ∈ {IDLE, READY, ERROR}:
        IDLE  -> CMD_RESET (seed row filled)   | CMD_STEP (action row filled)
    worker writes when ctrl[i] ∈ {CMD_RESET, CMD_STEP}:
        CMD_* -> READY (result rows filled)    | ERROR (err row filled)
    parent harvests READY -> IDLE after copying the result rows out.

Shutdown is a separate parent-owned ``stop`` byte checked in every worker
wait loop — a worker mid-op finishes (or is terminated by ``close``) and
never races the parent for the ctrl slot.

Both sides wait with the same spin → ``sched_yield`` → escalating-sleep
ladder (``SpinConfig``); pure spinning would melt a shared box, pure
sleeping would add milliseconds of latency per step — the ladder gives
sub-100 µs reaction when the peer is fast and ~``max_sleep_us`` polling when
it is slow.

The counterpart of ``repro/core/shm.py``, without the span tracing (it
comes with the telemetry slice).

IMPORTANT: this module (the spawn-worker entrypoint) must stay importable
without torch — a CUDA context does not survive a fork, and importing torch
costs every one of up to M spawned workers a second or more. It imports
numpy and the stdlib only; ``tests/test_torch_host_pool.py`` has an
import-probe that fails if torch ever sneaks into the chain.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
from dataclasses import dataclass, field
from multiprocessing import shared_memory
from typing import Callable, Tuple

import numpy as np

# ctrl-slot states
IDLE = 0
CMD_RESET = 1
CMD_STEP = 2
READY = 3
ERROR = 4

ERR_BYTES = 1024         # per-env error row: [op u8][len u16le][utf-8 ...]
_ALIGN = 64              # section alignment (cache line)

_OPS = ("reset", "step")


@dataclass(frozen=True)
class SlabSpec:
    """Per-env row shapes/dtypes, derived from the emulation specs.

    ``obs_shape`` / ``act_shape`` are what one env's adapter produces and
    consumes per step — ``(obs_dim,)`` or ``(num_agents, obs_dim)`` f32 rows
    for observations, ``(num_components,)`` (or agent-major) int32/float32
    rows for emulated actions. ``rew_shape`` is ``()`` for single-agent envs
    and ``(num_agents,)`` for padded multi-agent rows. Dtypes are stored as
    names so the spec pickles canonically into the worker."""
    obs_shape: Tuple[int, ...]
    act_shape: Tuple[int, ...]
    act_dtype: str = "int32"
    rew_shape: Tuple[int, ...] = ()
    obs_dtype: str = "float32"


@dataclass(frozen=True)
class SpinConfig:
    """The busy-wait backoff ladder: ``spin`` raw re-checks, then ``yields``
    ``sched_yield`` slices, then sleeps escalating ``min_sleep_us`` →
    ``max_sleep_us``. A wait that drags past ``idle_after_s`` keeps
    escalating to ``idle_sleep_us`` — a worker nobody has commanded for that
    long is *idle*, not mid-handoff, and polling it at ``max_sleep_us``
    forever burns the core everyone else needs (with M ≫ cores, the boot
    storm alone starves un-booted siblings)."""
    spin: int = 200
    yields: int = 100
    min_sleep_us: float = 20.0
    max_sleep_us: float = 200.0
    idle_sleep_us: float = 10_000.0
    idle_after_s: float = 0.05


def default_spin(workers: int = 0) -> SpinConfig:
    """The pool's default ladder, oversubscription-aware: when worker
    processes outnumber cores (``workers >= os.cpu_count()``), busy-waiting
    *steals the core the peer needs* — spin less, sleep longer. On a box
    with headroom the aggressive ladder minimizes handoff latency."""
    cores = os.cpu_count() or 1
    if workers and workers >= cores:
        # long poll cap: on an oversubscribed box every wakeup steals CPU
        # from the workers actually stepping, and handoff latency is lost
        # in the noise anyway
        return SpinConfig(spin=20, yields=20, min_sleep_us=100.0,
                          max_sleep_us=2000.0, idle_sleep_us=20_000.0)
    return SpinConfig()


class SpinWait:
    """One wait episode of the ladder; ``reset()`` after the flag flips."""

    def __init__(self, cfg: SpinConfig):
        self.cfg = cfg
        self._n = 0
        self._sleep = cfg.min_sleep_us / 1e6
        self._slept = 0.0

    def reset(self):
        self._n = 0
        self._sleep = self.cfg.min_sleep_us / 1e6
        self._slept = 0.0

    def pause(self):
        c = self.cfg
        self._n += 1
        if self._n <= c.spin:
            return
        if self._n <= c.spin + c.yields:
            os.sched_yield()
            return
        time.sleep(self._sleep)
        self._slept += self._sleep
        cap = (c.idle_sleep_us if self._slept >= c.idle_after_s
               else c.max_sleep_us)
        self._sleep = min(self._sleep * 2, cap / 1e6)


def _section(offset: int, shape, dtype) -> Tuple[int, int]:
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    start = ((offset + _ALIGN - 1) // _ALIGN) * _ALIGN
    return start, start + n


class SlabLayout:
    """Byte layout of one pool's segment: M env rows per field."""

    FIELDS = ("ctrl", "stop", "seed", "obs", "act", "rew", "done", "score",
              "meta", "err")

    def __init__(self, spec: SlabSpec, M: int):
        self.spec, self.M = spec, M
        shapes = {
            "ctrl": ((M,), np.uint8),
            "stop": ((1,), np.uint8),
            "seed": ((M,), np.int64),
            "obs": ((M,) + tuple(spec.obs_shape), np.dtype(spec.obs_dtype)),
            "act": ((M,) + tuple(spec.act_shape), np.dtype(spec.act_dtype)),
            "rew": ((M,) + tuple(spec.rew_shape), np.float32),
            "done": ((M,), np.uint8),
            "score": ((M,), np.float32),
            "meta": ((M, 2), np.uint8),          # [is_step, has_score]
            "err": ((M, ERR_BYTES), np.uint8),
        }
        self.sections = {}
        end = 0
        for name in self.FIELDS:
            shape, dtype = shapes[name]
            start, end = _section(end, shape, dtype)
            self.sections[name] = (start, shape, dtype)
        self.nbytes = end

    def views(self, buf) -> dict:
        """Numpy views of every field over a shared-memory buffer."""
        out = {}
        for name, (start, shape, dtype) in self.sections.items():
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = np.frombuffer(
                buf, dtype=dtype, count=n, offset=start).reshape(shape)
        return out


def dumps_env_fn(fn: Callable) -> bytes:
    """Pickle an env factory for the spawn worker, with a useful error.

    Plain classes and ``functools.partial`` of module-level classes pickle
    fine; closures/lambdas need ``cloudpickle`` (used when installed)."""
    try:
        import cloudpickle as _cp      # optional — never a hard dependency
        return _cp.dumps(fn)
    except ImportError:
        pass
    try:
        return pickle.dumps(fn)
    except Exception as e:
        raise ValueError(
            f"backend='proc' spawns worker processes, so the env factory "
            f"must pickle; {fn!r} does not ({type(e).__name__}: {e}). Pass "
            f"a module-level class / function or functools.partial instead "
            f"of a lambda/closure (or install cloudpickle)") from e


@dataclass(frozen=True)
class WorkerConfig:
    """Everything one spawn worker needs (small and picklable)."""
    shm_name: str
    index: int
    M: int
    seed: int            # pool seed; autoreset episode e uses seed + i + M*e
    spec: SlabSpec
    spin: SpinConfig = field(default_factory=SpinConfig)
    payload: bytes = b""                 # pickled env factory
    stats: object = None                 # telemetry.procstats.StatSpec | None


def _write_error(views: dict, i: int, op: str, exc: BaseException) -> None:
    row = views["err"][i]
    text = f"{type(exc).__name__}: {exc}".encode("utf-8", "replace")
    text = text[:ERR_BYTES - 3]
    row[0] = _OPS.index(op)
    row[1] = len(text) & 0xFF
    row[2] = (len(text) >> 8) & 0xFF
    row[3:3 + len(text)] = np.frombuffer(text, np.uint8)


def read_error(views: dict, i: int) -> Tuple[str, str]:
    """(op, message) from env ``i``'s error row."""
    row = views["err"][i]
    op = _OPS[int(row[0])] if int(row[0]) < len(_OPS) else "step"
    n = int(row[1]) | (int(row[2]) << 8)
    return op, bytes(row[3:3 + n].tobytes()).decode("utf-8", "replace")


def attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment without registering it with the resource
    tracker.

    On 3.10 ``SharedMemory(name=...)`` registers the segment with the
    *attaching* process's tracker too (fixed by ``track=False`` only in
    3.13). Worker registrations corrupt the tracker's bookkeeping for a
    segment the parent owns — either the tracker unlinks the slab when a
    worker exits, or the parent's own unlink hits a KeyError. The parent
    owns the lifecycle; workers only map, so we silence ``register`` for
    the duration of the attach."""
    from multiprocessing import resource_tracker
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


def worker_main(cfg: WorkerConfig) -> None:
    """Spawn-worker entrypoint: busy-wait on the ctrl slot, step/reset the
    env in-process, write results into the slab rows. Autoreset seeding
    matches the thread backend exactly: episode ``e`` of env ``i`` resets
    with ``seed + i + M * e``."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda._is_in_bad_fork():
        # a spawned interpreter has no CUDA context to inherit; a forked
        # child of a parent that initialised CUDA does, and cannot use it
        # (and fork corrupts it). Enforce the spawn context at runtime.
        raise RuntimeError(
            "HostPool worker is a forked child of a process that "
            "initialised CUDA — it was forked, not spawned. ProcHostPool "
            "must use the 'spawn' start method "
            "(multiprocessing.get_context('spawn'))")
    seg = attach_untracked(cfg.shm_name)
    v = SlabLayout(cfg.spec, cfg.M).views(seg.buf)
    i = cfg.index
    env = None
    episode = 0
    spin = SpinWait(cfg.spin)
    slab = srow = None
    if cfg.stats is not None:
        # lock-free per-worker stat row (telemetry slab; parent aggregates).
        # Imported lazily: procstats depends on this module, and the import
        # stays torch-free either way.
        from repro_torch.telemetry.procstats import StatSlab
        slab = StatSlab.attach(cfg.stats)
        srow = slab.row(i)
    beat_i = 0
    try:
        while True:
            t_wait = time.monotonic_ns()
            if srow is not None:
                srow.set("last_beat_ns", time.time_ns())
            while True:                          # wait for a command
                if v["stop"][0]:
                    return
                cmd = int(v["ctrl"][i])
                if cmd in (CMD_RESET, CMD_STEP):
                    break
                spin.pause()
                beat_i += 1
                if srow is not None and not (beat_i & 63):
                    # idle-but-alive workers must keep beating, or /healthz
                    # would call a quiet worker dead; every-64th pause keeps
                    # the store off the hot handshake path
                    srow.set("last_beat_ns", time.time_ns())
            spin.reset()
            t_busy = time.monotonic_ns()
            if srow is not None:
                srow.add("wait_ns", t_busy - t_wait)
            op = "reset"
            try:
                if env is None:
                    env = pickle.loads(cfg.payload)()
                if cmd == CMD_RESET:
                    obs = env.reset(int(v["seed"][i]))
                    rew, done, score, has_score, is_step = \
                        0.0, False, 0.0, 0, 0
                else:
                    op = "step"
                    obs, rew, done, info = env.step(v["act"][i].copy())
                    is_step = 1
                    info = info if isinstance(info, dict) else {}
                    has_score = 1 if "score" in info else 0
                    score = float(info.get("score", 0.0))
                    if done:
                        episode += 1
                        op = "reset"
                        obs = env.reset(cfg.seed + i + cfg.M * episode)
                v["obs"][i] = np.asarray(obs, v["obs"].dtype).reshape(
                    cfg.spec.obs_shape)
                v["rew"][i] = np.asarray(rew, np.float32)
                v["done"][i] = np.uint8(bool(done))
                v["score"][i] = np.float32(score)
                v["meta"][i, 0] = np.uint8(is_step)
                v["meta"][i, 1] = np.uint8(has_score)
                v["ctrl"][i] = READY
                if srow is not None:
                    srow.add("steps" if is_step else "resets")
                    srow.add("busy_ns", time.monotonic_ns() - t_busy)
                    srow.set("last_beat_ns", time.time_ns())
            except Exception as e:   # noqa: BLE001 — forwarded to the parent
                _write_error(v, i, op, e)
                v["ctrl"][i] = ERROR
                if srow is not None:
                    srow.add("errors")
                return
    finally:
        close = getattr(env, "close", None)
        if callable(close):
            try:
                close()
            except Exception:
                pass
        del v, srow                              # release buffer views
        seg.close()
        if slab is not None:
            slab.close()
