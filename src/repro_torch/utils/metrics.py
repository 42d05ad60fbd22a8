"""Metrics logging (the paper's §6 "better logging and WandB integration",
dependency-free edition): JSONL stream + rolling aggregates, one file per
run, safe under checkpoint-restart (append mode, step-keyed) and under
interruption (context manager; ``close()`` is idempotent and always leaves
a complete final record on disk)."""
from __future__ import annotations

import json
import math
import os
import time
from typing import Optional


def _scrub(v: float):
    """JSON has no NaN/Inf: ``json.dumps`` with the default ``allow_nan``
    writes bare ``NaN`` tokens that ``json.loads`` round-trips but every
    strict parser (jq, browsers, pandas ``read_json``) rejects. Non-finite
    values become ``null`` — explicitly absent, not silently poisoned."""
    return v if math.isfinite(v) else None


class MetricsLogger:
    """JSONL metrics stream. Usable as a context manager::

        with MetricsLogger("runs/exp1", "bandit") as ml:
            ml.log(step, metrics)

    so an exception (or a normal exit) always flushes + fsyncs the final
    record instead of truncating it mid-line."""

    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run"):
        self.path = None
        self._f = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.jsonl")
            self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, flush: bool = True):
        if self._f is None:
            return
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = _scrub(float(v))
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")
        if flush:
            self._f.flush()

    def log_batch(self, records):
        """One write + flush for a whole launch of per-update metric dicts
        (each carrying its own ``env_steps``) — the host-side counterpart of
        the engine's once-per-launch metrics fetch."""
        if self._f is None:
            return
        for rec in records:
            self.log(int(rec.get("env_steps", 0)), rec, flush=False)
        self._f.flush()

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        """Idempotent: flush + fsync + close once; later calls are no-ops."""
        f, self._f = self._f, None
        if f is None:
            return
        try:
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            pass
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False


def read(path: str):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]
