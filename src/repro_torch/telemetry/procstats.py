"""Cross-process stat slabs: per-worker shared-memory counter rows.

Same slab idiom as ``core/shm.py`` (one segment, 64-byte-aligned, numpy
views, parent owns the lifecycle, workers attach untracked): a
``(rows, fields)`` int64 counter matrix. Each worker owns exactly one row
and is its only writer, so every update is a lock-free in-place add; the
parent aggregates with one vectorized ``sum`` — zero pickling, zero locks,
zero messages on the stats path.

Torn reads are tolerated by design: a parent aggregate racing a worker's
int64 add can see the value from just before or just after the add (int64
stores are atomic on the platforms we target), never garbage. Stats survive
worker death — the rows live in the parent-owned segment.

The counterpart of ``repro/telemetry/procstats.py`` with the host pool's
rows only: the actor rows and the staleness histogram come with the async
tier. torch-free: spawn workers import it.
"""
from __future__ import annotations

from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.shm import _ALIGN, _section, attach_untracked

__all__ = ["StatSpec", "StatRow", "StatSlab", "HOST_FIELDS"]

# ProcHostPool workers: env steps/resets, errors, ns spent waiting for a
# command vs. executing one, plus the wall-clock liveness beat.
# ``last_beat_ns`` is ``time.time_ns()`` (wall, cross-process comparable —
# not monotonic) set by the worker whenever it proves it is scheduled;
# ``HostPool.liveness`` reads its age to tell "slow" from "dead" without
# waiting for a recv timeout. A gauge, not a counter: use ``set``.
HOST_FIELDS = ("steps", "resets", "errors", "wait_ns", "busy_ns",
               "last_beat_ns")


@dataclass(frozen=True)
class StatSpec:
    """Everything a worker needs to attach its row (small and picklable)."""
    shm_name: str
    rows: int
    fields: Tuple[str, ...]


def _layout(spec: StatSpec):
    shape = (spec.rows, len(spec.fields))
    start, end = _section(0, shape, np.int64)
    # pad to alignment so the segment size is stable across platforms
    return start, shape, ((end + _ALIGN - 1) // _ALIGN) * _ALIGN


class StatRow:
    """One worker's writer handle: plain int64 adds on its own row.

    Holds a live view into the slab — drop every row (``del``) before
    calling ``StatSlab.close()`` or the mapping cannot unmap cleanly."""
    __slots__ = ("_row", "_idx")

    def __init__(self, counters: np.ndarray, index: int,
                 fields: Tuple[str, ...]):
        self._row = counters[index]
        self._idx = {f: i for i, f in enumerate(fields)}

    def add(self, field: str, n: int = 1) -> None:
        self._row[self._idx[field]] += n

    def set(self, field: str, v: int) -> None:
        self._row[self._idx[field]] = v


class StatSlab:
    """Parent-side owner (create/aggregate/unlink) and worker-side attach
    point for one stats segment."""

    def __init__(self, spec: StatSpec, segment: shared_memory.SharedMemory,
                 owner: bool):
        self.spec = spec
        self._seg = segment
        self._owner = owner
        start, shape, _ = _layout(spec)
        self.counters = np.frombuffer(
            segment.buf, dtype=np.int64,
            count=int(np.prod(shape)), offset=start).reshape(shape)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, rows: int,
               fields: Sequence[str] = HOST_FIELDS) -> "StatSlab":
        _, _, nbytes = _layout(StatSpec("", int(rows), tuple(fields)))
        seg = shared_memory.SharedMemory(create=True, size=nbytes)
        slab = cls(StatSpec(seg.name, int(rows), tuple(fields)), seg,
                   owner=True)
        slab.counters[:] = 0
        return slab

    @classmethod
    def attach(cls, spec: StatSpec) -> "StatSlab":
        return cls(spec, attach_untracked(spec.shm_name), owner=False)

    def close(self) -> None:
        # release views before closing the mapping (else BufferError)
        self.counters = None
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
        return StatRow(self.counters, int(index), self.spec.fields)

    def aggregate(self) -> dict:
        """Zero-pickle parent-side rollup: per-field totals and per-row
        values."""
        c = np.array(self.counters)          # one racing-tolerant copy
        return {
            "rows": int(self.spec.rows),
            "total": {f: int(c[:, i].sum())
                      for i, f in enumerate(self.spec.fields)},
            "per_worker": {f: c[:, i].tolist()
                           for i, f in enumerate(self.spec.fields)},
        }
