"""Cross-process trace propagation: one timeline across learner + workers.

The learner enables tracing with a run dir (``telemetry.enable``); spawn
workers — proc HostPool workers and async-tier actors — are separate
interpreters that inherit nothing. This module is the handshake:

1. The parent snapshots its live tracer into a picklable ``TraceConfig``
   (``current()``) and ships it inside the existing spawn-time config
   (``shm.WorkerConfig.trace`` / ``actor_learner.ActorConfig.trace``).
   When tracing is off, ``current()`` is ``None`` and workers pay nothing.
2. Each worker calls ``init_worker(cfg, role)``: it enables a process-local
   tracer writing ``spans-<pid>.jsonl`` in the same run dir, stamped with
   the shared trace id and the worker's own wall-vs-monotonic clock offset
   (``spans.clock_offset_ns``). The meta header is written eagerly, so a
   worker killed before its first flush still leaves a mergeable file.
3. ``merge_chrome_trace(run_dir)`` reads every ``spans*.jsonl``, maps each
   file's monotonic timestamps onto the shared wall clock via its recorded
   offset, and emits ONE Chrome trace with per-process pid lanes labeled
   by role (``process_name`` metadata events) — a learner ``launch`` and
   the worker ``step``s it waited on line up on one timeline.

Partial files are expected, not errors: a SIGKILLed worker can leave a
torn final line (flush is append + fsync, so at most the last line is
damaged) — unparsable lines are skipped, everything before them merges.

The counterpart of ``repro/telemetry/traceprop.py``. torch-free by design:
spawn workers import it.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.telemetry import spans

__all__ = [
    "TraceConfig", "current", "init_worker", "worker_spans_name",
    "load_run_spans", "merged_records", "merge_chrome_trace",
]

SPANS_GLOB = "spans*.jsonl"


@dataclass(frozen=True)
class TraceConfig:
    """Picklable snapshot of the parent's tracing state, shipped to spawn
    workers inside their start-up config."""
    run_dir: str
    trace_id: str
    capacity: int = 65536


def current() -> Optional[TraceConfig]:
    """The parent side of the handshake: ``None`` unless tracing is on
    with a run dir (ring-only tracing has nowhere for workers to flush)."""
    t = spans.get_tracer()
    if t is None or not t.run_dir:
        return None
    return TraceConfig(run_dir=t.run_dir, trace_id=t.trace_id,
                       capacity=t.capacity)


def worker_spans_name(pid: Optional[int] = None) -> str:
    return f"spans-{os.getpid() if pid is None else pid}.jsonl"


def init_worker(cfg: Optional[TraceConfig],
                role: str) -> Optional[spans.Tracer]:
    """The worker side: enable a per-process tracer writing its own
    ``spans-<pid>.jsonl`` (meta header written immediately). Returns the
    tracer, or ``None`` when the parent shipped no trace config."""
    if cfg is None:
        return None
    return spans.enable(cfg.run_dir, capacity=cfg.capacity,
                        file_name=worker_spans_name(),
                        trace_id=cfg.trace_id, role=role)


# -- merge ------------------------------------------------------------------
def load_run_spans(run_dir: str) -> List[Tuple[dict, List[dict]]]:
    """``[(meta, records), ...]`` — one entry per ``spans*.jsonl`` file.

    Tolerant by construction: unreadable files, blank lines, torn tails of
    killed workers, and records from pre-meta writers all degrade to "use
    what parses". A file whose meta never landed gets offset 0 and a pid
    recovered from its first span record.
    """
    out = []
    for path in sorted(glob.glob(os.path.join(run_dir, SPANS_GLOB))):
        meta = {"pid": None, "role": "", "clock_offset_ns": 0,
                "trace_id": ""}
        recs: List[dict] = []
        try:
            fh = open(path, "r")
        except OSError:
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except ValueError:
                    continue            # torn tail of a killed worker
                if not isinstance(r, dict):
                    continue
                if r.get("kind") == "meta":
                    meta.update(r)      # last meta wins (re-enabled tracer)
                elif "name" in r and "ts_ns" in r and "dur_ns" in r:
                    recs.append(r)
        if meta["pid"] is None and recs:
            meta["pid"] = recs[0].get("pid")
        if recs or meta["pid"] is not None:
            if not meta["role"]:
                base = os.path.basename(path)
                meta["role"] = ("main" if base == spans.SPANS_FILE
                                else f"pid-{meta['pid']}")
            out.append((meta, recs))
    return out


def merged_records(run_dir: str) -> List[dict]:
    """Every span from every process, ``ts_ns`` rebased onto the shared
    wall clock (per-file clock offset applied), sorted by start time."""
    merged = []
    for meta, recs in load_run_spans(run_dir):
        off = int(meta.get("clock_offset_ns") or 0)
        for r in recs:
            r = dict(r)
            r["ts_ns"] = int(r["ts_ns"]) + off
            if r.get("pid") is None:
                r["pid"] = meta["pid"]
            r["role"] = meta["role"]
            merged.append(r)
    merged.sort(key=lambda r: r["ts_ns"])
    return merged


def merge_chrome_trace(run_dir: str) -> dict:
    """One Chrome trace-event JSON over ALL processes in the run dir, with
    a pid lane per process named by role (learner / host-worker-i /
    actor-i) via ``process_name`` metadata events. Timestamps are wall-
    aligned and rebased so the trace starts near zero."""
    files = load_run_spans(run_dir)
    base = None
    for meta, recs in files:
        off = int(meta.get("clock_offset_ns") or 0)
        for r in recs:
            t = int(r["ts_ns"]) + off
            if base is None or t < base:
                base = t
    base = base or 0

    events = []
    lanes = {}
    for meta, recs in files:
        off = int(meta.get("clock_offset_ns") or 0)
        pid = meta["pid"] if meta["pid"] is not None else 0
        lanes.setdefault(int(pid), meta["role"])
        for r in recs:
            events.append({
                "name": r["name"],
                "cat": "repro_torch",
                "ph": "X",
                "ts": (int(r["ts_ns"]) + off - base) / 1e3,
                "dur": int(r["dur_ns"]) / 1e3,
                "pid": int(r.get("pid") or pid),
                "tid": int(r.get("tid") or 0),
                "args": {"depth": r.get("depth", 0),
                         "parent": r.get("parent", "")},
            })
    meta_events = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": role}}
        for pid, role in sorted(lanes.items())
    ]
    trace_ids = {m.get("trace_id") for m, _ in files if m.get("trace_id")}
    return {
        "traceEvents": meta_events + events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_ids": sorted(trace_ids),
                      "processes": len(files)},
    }
