"""Perf-regression sentinel: bench history recording + drift detection.

The counterpart of ``repro/telemetry/benchwatch.py``, a copy. Every
function takes the history path; the default is ``BENCH_history.jsonl``
in the working directory.

Every ``benchmarks/bench_*.py`` appends one schema-versioned JSON line to
``BENCH_history.jsonl`` (shared across all benches) via :func:`record`:

    {"schema": 1, "bench": "telemetry", "ts": "2026-08-08T…Z",
     "fingerprint": {"cores": 8, "python": "3.11", "platform": "Linux-x86_64"},
     "cells": {"jit_enabled_sps": 51234.0, ...},
     "acceptance": {"overhead_lt_10pct": true, ...},
     "meta": {...}}

``python -m repro_torch.telemetry compare`` then pits the newest record of each
bench against a rolling baseline (median of up to ``window`` prior records
with the SAME machine fingerprint) and flags any cell whose value dropped
by more than the noise band. Fingerprints gate comparison because an SPS
number from a 4-core CI runner says nothing about a 64-core dev box — a
mismatch means "no baseline yet", never a regression.

Report-only by default; ``--gate`` turns confirmed regressions into a
non-zero exit for CI lanes that want to block.

Cells are flat ``{name: value}`` dicts where bigger is better (SPS,
speedups, calls/s). Benches that measure wall time should record the
derived rate, not the seconds.
"""
from __future__ import annotations

import datetime
import json
import os
import platform
import sys
from typing import Dict, List, Optional

__all__ = [
    "SCHEMA", "HISTORY_FILE", "fingerprint", "record", "load_history",
    "compare", "format_report",
]

SCHEMA = 1
HISTORY_FILE = "BENCH_history.jsonl"
# relative drop beyond this fraction of baseline counts as a regression
DEFAULT_NOISE = 0.10
# rolling baseline = median of up to this many prior same-fingerprint records
DEFAULT_WINDOW = 5


def fingerprint() -> Dict[str, object]:
    """What must match for two bench records to be comparable. Coarse on
    purpose: cores + python minor + platform — not CPU model or load."""
    return {
        "cores": os.cpu_count() or 1,
        "python": f"{sys.version_info.major}.{sys.version_info.minor}",
        "platform": f"{platform.system()}-{platform.machine()}",
    }


def history_path(history: Optional[str] = None) -> str:
    """Default history file lives next to the BENCH_*.json results, i.e.
    the repo root (cwd of ``python benchmarks/bench_*.py`` runs)."""
    return history or HISTORY_FILE


def record(bench: str, cells: Dict[str, float], *,
           acceptance: Optional[Dict[str, bool]] = None,
           meta: Optional[dict] = None,
           history: Optional[str] = None) -> dict:
    """Append one bench run to the shared history file and return the
    record. Never raises on IO problems (a read-only checkout must not
    fail the bench) — returns the record either way."""
    rec = {
        "schema": SCHEMA,
        "bench": bench,
        "ts": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "fingerprint": fingerprint(),
        "cells": {k: float(v) for k, v in cells.items()
                  if isinstance(v, (int, float))},
        "acceptance": dict(acceptance or {}),
        "meta": dict(meta or {}),
    }
    path = history_path(history)
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:
        print(f"[benchwatch] could not append to {path}: {e}", file=sys.stderr)
    return rec


def load_history(history: Optional[str] = None) -> List[dict]:
    """All parseable records, file order (oldest first). Torn tails and
    foreign-schema lines are skipped, not fatal."""
    path = history_path(history)
    records: List[dict] = []
    if not os.path.exists(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("schema") == SCHEMA \
                    and "bench" in rec and isinstance(rec.get("cells"), dict):
                records.append(rec)
    return records


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    if n % 2:
        return float(s[mid])
    return float(s[mid - 1] + s[mid]) / 2.0


def compare(history: Optional[str] = None, *, noise: float = DEFAULT_NOISE,
            window: int = DEFAULT_WINDOW) -> dict:
    """Newest record of each bench vs. its rolling same-fingerprint
    baseline.

    Returns ``{"benches": {name: {"status", "cells", ...}},
    "regressions": [...]}`` where status is one of:

      * ``"ok"``           — every cell within the noise band (or improved)
      * ``"regression"``   — ≥1 cell dropped more than ``noise`` vs baseline
      * ``"no_baseline"``  — no prior record with a matching fingerprint
        (first run on this machine, or the machine changed) — never gates
    """
    records = load_history(history)
    by_bench: Dict[str, List[dict]] = {}
    for rec in records:
        by_bench.setdefault(rec["bench"], []).append(rec)

    out = {"benches": {}, "regressions": []}
    for bench, recs in by_bench.items():
        newest = recs[-1]
        fp = newest.get("fingerprint")
        prior = [r for r in recs[:-1] if r.get("fingerprint") == fp]
        prior = prior[-window:]
        if not prior:
            out["benches"][bench] = {
                "status": "no_baseline", "runs": len(recs),
                "fingerprint": fp, "cells": {}}
            continue
        cells = {}
        status = "ok"
        for name, value in newest["cells"].items():
            base_vals = [r["cells"][name] for r in prior
                         if isinstance(r["cells"].get(name), (int, float))]
            if not base_vals:
                cells[name] = {"value": value, "baseline": None,
                               "delta_pct": None, "status": "new_cell"}
                continue
            baseline = _median(base_vals)
            if baseline > 0:
                delta = (value - baseline) / baseline
            else:
                delta = 0.0
            cell_status = "ok"
            if delta < -noise:
                cell_status = "regression"
                status = "regression"
                out["regressions"].append(
                    {"bench": bench, "cell": name, "value": value,
                     "baseline": baseline, "delta_pct": round(delta * 100, 2)})
            cells[name] = {"value": value, "baseline": baseline,
                           "delta_pct": round(delta * 100, 2),
                           "status": cell_status}
        out["benches"][bench] = {
            "status": status, "runs": len(recs),
            "baseline_runs": len(prior), "fingerprint": fp, "cells": cells}
    return out


def format_report(result: dict) -> str:
    lines = ["bench history comparison", "=" * 40]
    for bench in sorted(result["benches"]):
        info = result["benches"][bench]
        lines.append(f"{bench}: {info['status']} "
                     f"({info['runs']} run(s) on record)")
        for name, cell in sorted(info.get("cells", {}).items()):
            if cell["baseline"] is None:
                lines.append(f"  {name}: {cell['value']:.4g} (new cell)")
            else:
                mark = " <-- REGRESSION" if cell["status"] == "regression" \
                    else ""
                lines.append(
                    f"  {name}: {cell['value']:.4g} vs baseline "
                    f"{cell['baseline']:.4g} ({cell['delta_pct']:+.1f}%)"
                    f"{mark}")
    n = len(result["regressions"])
    lines.append("-" * 40)
    lines.append(f"{n} regression(s) beyond the noise band"
                 if n else "no regressions beyond the noise band")
    return "\n".join(lines)
