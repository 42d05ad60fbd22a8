"""Cross-process stat slabs: per-worker shared-memory counter rows.

Same slab idiom as ``core/shm.py`` (one segment, 64-byte-aligned sections,
numpy views, parent owns the lifecycle, workers attach untracked): a
``(rows, fields)`` int64 counter matrix plus an optional ``(rows, buckets)``
int64 histogram matrix. Each worker/actor owns exactly one row and is its
only writer, so every update is a lock-free in-place add; the parent
aggregates with one vectorized ``sum`` — **zero pickling, zero locks, zero
messages** on the stats path.

Torn reads are tolerated by design: a parent aggregate racing a worker's
int64 add can see the value from just-before or just-after the add (int64
stores are atomic on the platforms we target), never garbage. Stats survive
worker death — the rows live in the parent-owned segment, so a killed
worker's counters stay readable and survivors keep writing theirs.

The counterpart of ``repro/telemetry/procstats.py``. torch-free: spawn
workers import it.
"""
from __future__ import annotations

from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.shm import _ALIGN, _section, attach_untracked

__all__ = ["StatSpec", "StatRow", "StatSlab",
           "HOST_FIELDS", "ACTOR_FIELDS", "STALENESS_EDGES"]

# ProcHostPool workers: env steps/resets, errors, ns spent waiting for a
# command vs. executing one, plus the wall-clock liveness beat.
# ``last_beat_ns`` is ``time.time_ns()`` (wall, cross-process comparable —
# NOT monotonic) set by the worker whenever it proves it is scheduled;
# ``HostPool.liveness`` reads its age to tell "slow" from "dead" without
# waiting for a recv timeout. A gauge, not a counter: use ``set``.
HOST_FIELDS = ("steps", "resets", "errors", "wait_ns", "busy_ns",
               "last_beat_ns")

# actor_learner actors: env steps, committed fragments, ring-full stalls,
# seqlock read retries, param refreshes, errors, wait vs. inference ns,
# and the same wall-clock liveness beat as HOST_FIELDS.
ACTOR_FIELDS = ("steps", "fragments", "ring_full", "seqlock_retries",
                "param_loads", "errors", "wait_ns", "busy_ns",
                "last_beat_ns")

# staleness histogram (learner-updates-behind at fragment commit): buckets
# are <=0, <=1, <=2, <=4, <=8, >8
STALENESS_EDGES = (0.0, 1.0, 2.0, 4.0, 8.0)


@dataclass(frozen=True)
class StatSpec:
    """Everything a worker needs to attach its row (small and picklable)."""
    shm_name: str
    rows: int
    fields: Tuple[str, ...]
    hist_edges: Tuple[float, ...] = ()

    @property
    def hist_buckets(self) -> int:
        return len(self.hist_edges) + 1 if self.hist_edges else 0


def _layout(spec: StatSpec):
    counters_shape = (spec.rows, len(spec.fields))
    start_c, end = _section(0, counters_shape, np.int64)
    sections = {"counters": (start_c, counters_shape)}
    if spec.hist_buckets:
        hist_shape = (spec.rows, spec.hist_buckets)
        start_h, end = _section(end, hist_shape, np.int64)
        sections["hist"] = (start_h, hist_shape)
    # pad to alignment so the segment size is stable across platforms
    nbytes = ((end + _ALIGN - 1) // _ALIGN) * _ALIGN
    return sections, nbytes


class StatRow:
    """One worker's writer handle: plain int64 adds on its own row.

    Holds live views into the slab — drop every row (``del``) before
    calling ``StatSlab.close()`` or the mapping cannot unmap cleanly."""
    __slots__ = ("_row", "_hist", "_idx", "_edges")

    def __init__(self, counters: np.ndarray, hist: Optional[np.ndarray],
                 index: int, fields: Tuple[str, ...],
                 edges: Tuple[float, ...]):
        self._row = counters[index]
        self._hist = None if hist is None else hist[index]
        self._idx = {f: i for i, f in enumerate(fields)}
        self._edges = edges

    def add(self, field: str, n: int = 1) -> None:
        self._row[self._idx[field]] += n

    def set(self, field: str, v: int) -> None:
        self._row[self._idx[field]] = v

    def observe(self, v: float) -> None:
        """Bump the histogram bucket for ``v`` (no-op without a histogram)."""
        h = self._hist
        if h is None:
            return
        i = 0
        for e in self._edges:
            if v <= e:
                break
            i += 1
        h[i] += 1


class StatSlab:
    """Parent-side owner (create/aggregate/unlink) and worker-side attach
    point for one stats segment."""

    def __init__(self, spec: StatSpec, segment: shared_memory.SharedMemory,
                 owner: bool):
        self.spec = spec
        self._seg = segment
        self._owner = owner
        sections, _ = _layout(spec)
        start, shape = sections["counters"]
        self.counters = np.frombuffer(
            segment.buf, dtype=np.int64,
            count=int(np.prod(shape)), offset=start).reshape(shape)
        self.hist = None
        if "hist" in sections:
            start, shape = sections["hist"]
            self.hist = np.frombuffer(
                segment.buf, dtype=np.int64,
                count=int(np.prod(shape)), offset=start).reshape(shape)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, rows: int, fields: Sequence[str] = HOST_FIELDS,
               hist_edges: Sequence[float] = ()) -> "StatSlab":
        probe = StatSpec("", int(rows), tuple(fields), tuple(hist_edges))
        _, nbytes = _layout(probe)
        seg = shared_memory.SharedMemory(create=True, size=nbytes)
        spec = StatSpec(seg.name, int(rows), tuple(fields), tuple(hist_edges))
        slab = cls(spec, seg, owner=True)
        slab.counters[:] = 0
        if slab.hist is not None:
            slab.hist[:] = 0
        return slab

    @classmethod
    def attach(cls, spec: StatSpec) -> "StatSlab":
        return cls(spec, attach_untracked(spec.shm_name), owner=False)

    def close(self) -> None:
        # release views before closing the mapping (else BufferError)
        self.counters = None
        self.hist = None
        try:
            self._seg.close()
        except Exception:
            pass
        if self._owner:
            try:
                self._seg.unlink()
            except Exception:
                pass

    # -- access ------------------------------------------------------------
    def row(self, index: int) -> StatRow:
        return StatRow(self.counters, self.hist, int(index),
                       self.spec.fields, self.spec.hist_edges)

    def aggregate(self) -> dict:
        """Zero-pickle parent-side rollup: per-field totals, per-row values,
        and the summed histogram."""
        c = np.array(self.counters)          # one racing-tolerant copy
        out = {
            "rows": int(self.spec.rows),
            "total": {f: int(c[:, i].sum())
                      for i, f in enumerate(self.spec.fields)},
            "per_worker": {f: c[:, i].tolist()
                           for i, f in enumerate(self.spec.fields)},
        }
        if self.hist is not None:
            h = np.array(self.hist)
            out["hist"] = {
                "edges": list(self.spec.hist_edges),
                "counts": h.sum(axis=0).astype(int).tolist(),
                "per_worker": h.astype(int).tolist(),
            }
        return out
