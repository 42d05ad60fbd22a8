"""Fault tolerance and straggler mitigation for the training loop.

The counterpart of ``repro/distributed/fault.py``. Mechanisms:
  * checkpoint/restart — atomic committed checkpoints (checkpoint.ckpt),
    ``resume_or_init`` picks up the latest on relaunch; with ``shardings``
    (a tree of ``distributed.sharding.NamedSharding``) each rank saves its
    blocks and restores its region, onto any mesh.
  * step-scoped retry — a failing step (device error, preemption signal)
    triggers restore-from-last-commit and replay; repeated failure at the
    same step aborts with a clear report (poison-pill detection).
  * straggler detection — per-step wall times are tracked; hosts slower than
    ``k×median`` over a window are flagged (on a real cluster the launcher
    would re-shard around them; here we log and expose the signal).

This module imports no torch: the async actor–learner tier's spawned
actors import ``repro_torch.distributed`` in a fresh interpreter. A step's
failure is detected by synchronising with the device its first output
tensor lives on (torch is in the process by then).
"""
from __future__ import annotations

import collections
import os
import sys
import time
from typing import Callable, Iterable, Optional, Sequence, Union

from repro_torch.checkpoint import ckpt


def _true_median(xs) -> float:
    """The actual median: mean of the two middle elements for even-length
    windows (``sorted[n // 2]`` alone is the *upper*-middle element, which
    inflated the k×median straggler threshold early in the window and
    under-flagged genuinely slow steps)."""
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return float(s[mid])
    return float(s[mid - 1] + s[mid]) / 2.0


class StragglerMonitor:
    """Rolling per-step wall-time stats with k×median flagging (the paper's
    EnvPool insight at pod scale: never wait on the slowest worker)."""

    def __init__(self, window: int = 64, k: float = 2.0, min_samples: int = 8):
        self.times = collections.deque(maxlen=window)
        self.k = k
        self.min_samples = min_samples
        self.flagged = 0
        self.last_seen: Optional[float] = None   # monotonic s of last record

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        self.last_seen = time.monotonic()
        if len(self.times) >= self.min_samples:
            if dt > self.k * _true_median(self.times):
                self.flagged += 1
                return True
        return False

    @property
    def median(self) -> float:
        return _true_median(self.times)

    def age(self) -> Optional[float]:
        """Seconds since the last recorded arrival — the staleness signal
        /healthz and the async tier's metrics surface. ``None`` until the
        first record (a monitor that never saw a sample is booting, not
        stale)."""
        if self.last_seen is None:
            return None
        return time.monotonic() - self.last_seen

    def stats(self) -> dict:
        """The monitor's exportable view: rolling median, flag count, and
        seconds-since-last-arrival staleness age."""
        return {"median_s": self.median, "flagged": int(self.flagged),
                "samples": len(self.times), "age_s": self.age()}


def _first_tensor(tree):
    """The first tensor leaf of ``tree`` in checkpoint flatten order, or
    None."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    for _, leaf in ckpt._flatten_with_names(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


def _block_until_ready(tree) -> None:
    """Wait for the device work behind ``tree``'s first tensor: a device
    error surfaces here, inside the loop's ``try``, and not steps later."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        sys.modules["torch"].cuda.current_stream(leaf.device).synchronize()


class ResilientLoop:
    """Wraps a ``step(state, batch) -> (state, metrics)`` with
    checkpoint/restart fault tolerance.

    The ``batches`` contract (what ``run`` accepts, and what recovery can
    promise for each):

      * a **Sequence** (``len`` + integer indexing) — fully replayable.
        ``batches[i]`` drives step ``i + 1``; on a step failure the loop
        restores the newest committed checkpoint (step S), rewinds
        ``steps_done`` to S, and replays batches ``S, S+1, …`` so every
        batch is applied exactly once along the surviving state lineage.
        ``on_metrics`` re-fires for the replayed steps.
      * a **callable** ``batches(start_step) -> iterator`` — replayable by
        construction; recovery calls it again with the restored step.
      * a bare **iterator/iterable** — a live stream (e.g. the async tier's
        rollout-fragment source). It cannot be rewound, so recovery retries
        the *current* batch only; the checkpoint is restored only when it
        sits exactly at ``steps_done`` (restoring an older one would desync
        params from a stream that cannot replay the skipped batches — the
        bug this contract exists to prevent).

    ``ckpt_dir=None`` (or ``save_every <= 0``) disables checkpointing; the
    loop still retries failed steps against the current state.
    """

    def __init__(self, step_fn: Callable, ckpt_dir: Optional[str],
                 save_every: int = 100, max_retries: int = 3,
                 async_save: bool = True, shardings=None,
                 keep: Optional[int] = 3):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_retries = max_retries
        self.async_save = async_save
        self.shardings = shardings
        self.keep = keep
        self.monitor = StragglerMonitor()
        self._save_handle = None
        self.steps_done = 0
        self.recoveries = 0

    # -- checkpoint plumbing ---------------------------------------------------
    def _latest(self) -> Optional[str]:
        """Newest committed checkpoint path — ``ckpt_dir`` may itself be a
        committed checkpoint (manually named/renamed dir with an
        ``index.json``), else the newest ``step_N`` under it."""
        if self.ckpt_dir is None:
            return None
        if os.path.exists(os.path.join(self.ckpt_dir, "index.json")):
            return self.ckpt_dir
        return ckpt.latest(self.ckpt_dir)

    def resume_or_init(self, init_state):
        """Latest committed checkpoint if present, else the given state.

        The step count comes from the checkpoint's own metadata
        (``ckpt.step_of`` reads ``index.json``) — never from parsing the
        directory path, which silently mis-parsed (or crashed on) any
        ``ckpt_dir`` whose basename contains an underscore or a manually
        renamed checkpoint dir. ``init_state`` is also the structure (and
        the devices) the checkpoint restores into."""
        path = self._latest()
        if path is None:
            return init_state, 0
        state = ckpt.restore(path, init_state, self.shardings)
        return state, ckpt.step_of(path)

    def join_save(self) -> None:
        """Wait for the in-flight async save, if any, to commit."""
        if self._save_handle is not None:
            self._save_handle.join()
            self._save_handle = None

    def _save(self, state):
        if self._save_handle is not None:
            self._save_handle.join()   # one in-flight save at a time
        kw = {} if self.shardings is None else {"shardings": self.shardings}
        out = ckpt.save(self.ckpt_dir, state, step=self.steps_done,
                        async_=self.async_save, keep=self.keep, **kw)
        self._save_handle = out if self.async_save else None

    # -- the batch-source protocol ---------------------------------------------
    @staticmethod
    def _replay_fn(batches):
        """``start_step -> iterator`` for replayable sources, None for live
        streams (see the class docstring for the contract)."""
        if callable(batches):
            return lambda start: iter(batches(start))
        if isinstance(batches, Sequence) or (
                hasattr(batches, "__len__") and hasattr(batches, "__getitem__")):
            return lambda start: (batches[i]
                                  for i in range(start, len(batches)))
        return None

    def run(self, state, batches: Union[Sequence, Callable, Iterable],
            on_metrics: Optional[Callable] = None):
        """Iterate ``batches``; survives step failures via restore+replay
        (replayable sources) or restore-in-place+retry (live streams)."""
        replay = self._replay_fn(batches)
        it = replay(self.steps_done) if replay is not None else iter(batches)
        retries = 0
        pending = None
        exhausted = object()
        while True:
            if pending is None:
                pending = next(it, exhausted)
                if pending is exhausted:
                    break
            t0 = time.perf_counter()
            try:
                state, metrics = self.step_fn(state, pending)
                # the sync is the failure detector: a device error only
                # surfaces when the step's result is waited for (fall back
                # to a state leaf when a step emits no tensor metrics)
                _block_until_ready(metrics if _first_tensor(metrics)
                                   is not None else state)
            except Exception as e:   # device failure / preemption
                retries += 1
                self.recoveries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"step {self.steps_done + 1} failed {retries}x; "
                        f"aborting (poison pill?)") from e
                path = self._latest()
                if path is not None:
                    step = ckpt.step_of(path)
                    if replay is not None:
                        # restore AND rewind: replay batches step..steps_done
                        # so none are skipped and none applied twice on the
                        # surviving lineage
                        state, _ = self.resume_or_init(state)
                        self.steps_done = step
                        it = replay(step)
                        pending = None
                    elif step == self.steps_done:
                        # live stream: the checkpoint matches the stream
                        # position exactly, so restoring is a pure state
                        # refresh — retry the same pending batch
                        state, _ = self.resume_or_init(state)
                    # else: checkpoint is behind an unrewindable stream;
                    # retry the pending batch against the current state
                continue
            retries = 0
            slow = self.monitor.record(time.perf_counter() - t0)
            if slow:
                metrics = dict(metrics, straggler_flag=True)
            self.steps_done += 1
            pending = None
            if on_metrics:
                on_metrics(self.steps_done, metrics)
            if (self.ckpt_dir is not None and self.save_every > 0
                    and self.steps_done % self.save_every == 0):
                self._save(state)
        if self._save_handle is not None:
            self._save_handle.join()
        return state
