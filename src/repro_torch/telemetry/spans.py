"""Low-overhead span tracer: the timing substrate for every hot path.

Design constraints, in order:

1. **Disabled must be free.** ``span(name)`` with telemetry off returns a
   module-level ``_NullSpan`` singleton — no allocation, no clock read, one
   global load and one ``is None`` test. Hot loops (engine launch/fetch,
   host recv, actor fragment commits) keep their span calls unconditionally;
   the cost only exists when someone turned tracing on.
2. **Enabled must be cheap.** One ``time.monotonic_ns()`` pair per span and
   one ``deque.append`` (GIL-atomic, so thread-safe without a lock) into a
   bounded ring. No string formatting, no dict building on the hot path.
3. **Host-side only.** Spans wrap Python host code — launch dispatch, device
   fetches, shared-memory waits. A span around enqueued device work times
   the enqueue, not the device.

Nesting is tracked per-thread/task via a ``contextvars.ContextVar`` depth
counter so the Chrome trace export reconstructs the flame graph. Export
targets: ``spans.jsonl`` (one record per span, appended by ``flush()``) and
the Chrome trace-event JSON that Perfetto / ``chrome://tracing`` loads.

The counterpart of ``repro/telemetry/spans.py``. torch-free by design: spawn
workers (``core/shm.py`` / ``actor_main``) import this module, and the host
pool's workers never import torch.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from contextvars import ContextVar
from typing import List, NamedTuple, Optional

__all__ = [
    "Tracer", "SpanRecord", "span", "CachedSpan", "enable", "disable",
    "enabled", "get_tracer", "flush", "clock_offset_ns", "percentile",
    "summarize_records",
]

SPANS_FILE = "spans.jsonl"


def clock_offset_ns() -> int:
    """Wall-clock minus monotonic-clock offset for THIS process, in ns.

    Span timestamps use ``time.monotonic_ns()`` (cheap, never steps
    backward) whose epoch is arbitrary per process — raw ``ts_ns`` values
    from two processes are not comparable. Each process records its own
    offset once, in its spans-file meta header, and the merge step maps
    every span onto the shared wall clock via ``ts_ns + offset``. Median
    of five tight samples rejects a scheduler preemption landing between
    the two clock reads.
    """
    samples = []
    for _ in range(5):
        a = time.monotonic_ns()
        w = time.time_ns()
        b = time.monotonic_ns()
        samples.append(w - (a + b) // 2)
    samples.sort()
    return samples[2]

# (depth, parent-name) of the innermost open span on this thread/task
_STACK: ContextVar[tuple] = ContextVar("repro_span_stack", default=(0, ""))


class SpanRecord(NamedTuple):
    """One completed span. ``ts_ns`` is ``time.monotonic_ns()`` at entry —
    comparable within a process, not across processes."""
    name: str
    ts_ns: int
    dur_ns: int
    pid: int
    tid: int
    depth: int
    parent: str


class _NullSpan:
    """The disabled fast path: a stateless singleton context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span (enabled path). Records itself into the tracer ring on
    exit; exceptions propagate (the span still records its duration)."""
    __slots__ = ("_ring", "name", "_t0", "_tok", "_depth", "_parent")

    def __init__(self, ring: deque, name: str):
        self._ring = ring
        self.name = name

    def __enter__(self):
        depth, _parent = _STACK.get((0, ""))   # ContextVar read, never blocks
        self._depth = depth
        self._parent = _parent
        self._tok = _STACK.set((depth + 1, self.name))
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, et, ev, tb):
        dur = time.monotonic_ns() - self._t0
        _STACK.reset(self._tok)
        self._ring.append(SpanRecord(
            self.name, self._t0, dur, os.getpid(),
            threading.get_ident() & 0xFFFFFFFF, self._depth, self._parent))
        return False


class CachedSpan:
    """A reusable named span for non-reentrant hot call sites.

    ``span(name)`` allocates one ``_Span`` per use on the enabled path;
    a ``CachedSpan`` held by the call site (e.g. ``TierTimer``'s launch /
    fetch contexts) is allocation-free in BOTH modes: the tracer is
    re-read on every ``__enter__`` so mid-run enable/disable still works.
    Not safe for the same instance to be entered concurrently from two
    threads or re-entered recursively — one instance per call site.
    """
    __slots__ = ("name", "_ring", "_t0", "_tok", "_depth", "_parent")

    def __init__(self, name: str):
        self.name = name
        self._ring = None

    def __enter__(self):
        t = _TRACER
        if t is None:
            self._ring = None
            return self
        self._ring = t._ring
        depth, parent = _STACK.get((0, ""))
        self._depth = depth
        self._parent = parent
        self._tok = _STACK.set((depth + 1, self.name))
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, et, ev, tb):
        ring = self._ring
        if ring is None:
            return False
        dur = time.monotonic_ns() - self._t0
        _STACK.reset(self._tok)
        self._ring = None
        ring.append(SpanRecord(
            self.name, self._t0, dur, os.getpid(),
            threading.get_ident() & 0xFFFFFFFF, self._depth, self._parent))
        return False


class Tracer:
    """Bounded ring of completed spans. ``deque(maxlen=)`` appends are
    GIL-atomic, so concurrent host threads record without a lock; the lock
    below only serializes drains/flushes against each other.

    With a ``run_dir``, the tracer owns one spans file (``file_name``,
    default ``spans.jsonl``; workers use ``spans-<pid>.jsonl``) and writes
    a meta header line on creation — ``{"kind": "meta", trace_id, pid,
    role, clock_offset_ns}`` — eagerly, so even a process killed before
    its first flush leaves a mergeable (if empty) file behind.
    """

    def __init__(self, run_dir: Optional[str] = None, capacity: int = 65536,
                 *, file_name: Optional[str] = None,
                 trace_id: Optional[str] = None, role: str = "main"):
        self.run_dir = run_dir
        self.capacity = int(capacity)
        self.file_name = file_name or SPANS_FILE
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.role = role
        self.clock_offset_ns = clock_offset_ns()
        self._ring: deque = deque(maxlen=self.capacity)
        self._io_lock = threading.Lock()
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._write_meta()

    def _write_meta(self) -> None:
        rec = {"kind": "meta", "schema": 1, "trace_id": self.trace_id,
               "pid": os.getpid(), "role": self.role,
               "clock_offset_ns": self.clock_offset_ns}
        path = os.path.join(self.run_dir, self.file_name)
        with self._io_lock, open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- recording ---------------------------------------------------------
    def span(self, name: str) -> _Span:
        return _Span(self._ring, name)

    def records(self) -> List[SpanRecord]:
        """Snapshot of the ring without draining it."""
        return list(self._ring)

    def drain(self) -> List[SpanRecord]:
        """Atomically take everything recorded so far."""
        with self._io_lock:
            out = []
            ring = self._ring
            while True:
                try:
                    out.append(ring.popleft())
                except IndexError:
                    return out

    # -- export ------------------------------------------------------------
    def flush(self) -> int:
        """Append drained spans to ``<run_dir>/<file_name>``; returns the
        number written. Without a run_dir the ring just keeps accumulating
        (bounded) and flush is a no-op returning 0."""
        if not self.run_dir:
            return 0
        recs = self.drain()
        if not recs:
            return 0
        path = os.path.join(self.run_dir, self.file_name)
        with self._io_lock, open(path, "a") as f:
            for r in recs:
                f.write(json.dumps(r._asdict()) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return len(recs)

    def summary(self) -> dict:
        return summarize_records(self.records())

    def to_chrome_trace(self, records: Optional[List[SpanRecord]] = None) -> dict:
        return chrome_trace(self.records() if records is None else records)


# -- module-level switch ---------------------------------------------------
_TRACER: Optional[Tracer] = None


def span(name: str):
    """THE hot-path entry point. Disabled: returns the shared no-op span
    (zero allocations). Enabled: returns a recording span."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _Span(t._ring, name)


def enable(run_dir: Optional[str] = None, capacity: int = 65536, *,
           file_name: Optional[str] = None, trace_id: Optional[str] = None,
           role: str = "main") -> Tracer:
    """Turn tracing on process-wide; returns the (new) tracer. Re-enabling
    with the same args keeps the existing tracer so spans survive."""
    global _TRACER
    if (_TRACER is not None and _TRACER.run_dir == run_dir
            and _TRACER.capacity == int(capacity)
            and _TRACER.file_name == (file_name or SPANS_FILE)):
        return _TRACER
    _TRACER = Tracer(run_dir=run_dir, capacity=capacity,
                     file_name=file_name, trace_id=trace_id, role=role)
    return _TRACER


def disable() -> None:
    """Turn tracing off (flushing any pending spans first)."""
    global _TRACER
    if _TRACER is not None:
        try:
            _TRACER.flush()
        finally:
            _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def flush() -> int:
    """Flush the active tracer (no-op when disabled)."""
    t = _TRACER
    return t.flush() if t is not None else 0


# -- pure helpers (shared with the CLI) ------------------------------------
def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return float(sorted_vals[i])


def summarize_records(records) -> dict:
    """Per-name stats: count / total_ms / mean_ms / p50_ms / p99_ms / max_ms.
    Accepts SpanRecords or dicts (the spans.jsonl rows)."""
    by_name: dict = {}
    for r in records:
        if isinstance(r, dict):
            name, dur = r["name"], int(r["dur_ns"])
        else:
            name, dur = r.name, r.dur_ns
        by_name.setdefault(name, []).append(dur)
    out = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        total = sum(durs)
        out[name] = {
            "count": len(durs),
            "total_ms": total / 1e6,
            "mean_ms": total / len(durs) / 1e6,
            "p50_ms": percentile(durs, 0.50) / 1e6,
            "p99_ms": percentile(durs, 0.99) / 1e6,
            "max_ms": durs[-1] / 1e6,
        }
    return out


def chrome_trace(records) -> dict:
    """Chrome trace-event JSON (``ph: "X"`` complete events, µs units) —
    loads directly in Perfetto / chrome://tracing."""
    events = []
    for r in records:
        if isinstance(r, dict):
            r = SpanRecord(**r)
        events.append({
            "name": r.name,
            "cat": "repro_torch",
            "ph": "X",
            "ts": r.ts_ns / 1e3,
            "dur": r.dur_ns / 1e3,
            "pid": r.pid,
            "tid": r.tid,
            "args": {"depth": r.depth, "parent": r.parent},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
