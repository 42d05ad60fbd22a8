"""Run-inspection CLI: the counterpart of ``python -m repro.telemetry``,
on a port run directory (``launch.train --run-dir``).

    python -m repro_torch.telemetry summarize <run_dir>
        Per-span p50/p99 latency table (merged across the learner's
        spans.jsonl and every worker's spans-<pid>.jsonl) plus an SPS
        curve reconstructed from the run's metrics JSONL stream.

    python -m repro_torch.telemetry export-trace <run_dir> [--out trace.json]
        Merge all spans*.jsonl files into ONE Chrome trace-event JSON
        (Perfetto / chrome://tracing) with per-process lanes: worker
        timestamps are rebased onto the shared wall clock via each
        file's recorded clock offset, so a learner ``launch`` and the
        worker ``step``s it waited on line up on one timeline.

    python -m repro_torch.telemetry compare [--history BENCH_history.jsonl]
                                      [--gate] [--noise 0.1] [--window 5]
        Compare the newest bench record per bench against its rolling
        same-machine baseline (see telemetry/benchwatch.py). Report-only
        by default; --gate exits non-zero on confirmed regressions.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.telemetry import benchwatch, traceprop
from repro_torch.telemetry.spans import percentile, summarize_records

_SPARK = "▁▂▃▄▅▆▇█"


def _read_jsonl(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_spans(run_dir: str) -> list:
    """All span records in the run dir, merged across processes and
    rebased onto the shared wall clock (meta header lines excluded)."""
    return traceprop.merged_records(run_dir)


def load_metrics(run_dir: str) -> list:
    """All metric records in the run dir (every *.jsonl except span
    files), ordered by env_steps/step."""
    recs = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*.jsonl"))):
        base = os.path.basename(path)
        if base.startswith("spans") and base.endswith(".jsonl"):
            continue
        recs.extend(_read_jsonl(path))
    recs.sort(key=lambda r: r.get("env_steps", r.get("step", 0)))
    return recs


def sparkline(vals, width: int = 48) -> str:
    if not vals:
        return ""
    if len(vals) > width:                       # downsample by striding
        stride = len(vals) / width
        vals = [vals[int(i * stride)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / rng * (len(_SPARK) - 1))]
                   for v in vals)


def summarize(run_dir: str, out=sys.stdout) -> dict:
    """Print the summary; returns the data (the tests consume the dict)."""
    spans = load_spans(run_dir)
    summary = summarize_records(spans)
    procs = sorted({(r.get("pid"), r.get("role", "main")) for r in spans})
    w = max([len(n) for n in summary] + [4])
    print(f"# spans — {len(spans)} records, {len(summary)} names, "
          f"{len(procs)} process(es) ({run_dir})", file=out)
    hdr = (f"{'name':<{w}}  {'count':>7}  {'p50_ms':>9}  {'p99_ms':>9}  "
           f"{'mean_ms':>9}  {'max_ms':>9}  {'total_ms':>10}")
    print(hdr, file=out)
    print("-" * len(hdr), file=out)
    for name, s in summary.items():
        print(f"{name:<{w}}  {s['count']:>7}  {s['p50_ms']:>9.3f}  "
              f"{s['p99_ms']:>9.3f}  {s['mean_ms']:>9.3f}  "
              f"{s['max_ms']:>9.3f}  {s['total_ms']:>10.1f}", file=out)

    metrics = load_metrics(run_dir)
    sps = [r["sps"] for r in metrics
           if isinstance(r.get("sps"), (int, float))]
    curve = {}
    if sps:
        srt = sorted(sps)
        curve = {"n": len(sps), "min": srt[0], "max": srt[-1],
                 "mean": sum(sps) / len(sps),
                 "p50": percentile(srt, 0.5), "last": sps[-1]}
        print(f"\n# sps curve — {curve['n']} updates  "
              f"min {curve['min']:.0f}  p50 {curve['p50']:.0f}  "
              f"max {curve['max']:.0f}  last {curve['last']:.0f}", file=out)
        print(sparkline(sps), file=out)
    elif metrics:
        print(f"\n# {len(metrics)} metric records (no sps key)", file=out)
    return {"spans": summary, "sps_curve": curve,
            "n_span_records": len(spans), "n_processes": len(procs)}


def export_trace(run_dir: str, out_path: str) -> int:
    """Merged multi-process Chrome trace; returns the number of duration
    (``ph: "X"``) events written — lane-name metadata events don't count."""
    trace = traceprop.merge_chrome_trace(run_dir)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.telemetry",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summarize", help="p50/p99 per span + SPS curve")
    ps.add_argument("run_dir")
    pe = sub.add_parser("export-trace",
                        help="merge spans*.jsonl -> one Chrome trace JSON")
    pe.add_argument("run_dir")
    pe.add_argument("--out", default="")
    pc = sub.add_parser("compare",
                        help="newest bench record vs rolling baseline")
    pc.add_argument("--history", default=benchwatch.HISTORY_FILE)
    pc.add_argument("--gate", action="store_true",
                    help="exit 1 on confirmed regressions (default: report)")
    pc.add_argument("--report-only", action="store_true",
                    help="explicit no-gate (the default; for CI readability)")
    pc.add_argument("--noise", type=float, default=benchwatch.DEFAULT_NOISE)
    pc.add_argument("--window", type=int, default=benchwatch.DEFAULT_WINDOW)
    args = p.parse_args(argv)

    if args.cmd == "compare":
        result = benchwatch.compare(args.history, noise=args.noise,
                                    window=args.window)
        print(benchwatch.format_report(result))
        if args.gate and not args.report_only and result["regressions"]:
            return 1
        return 0

    if not os.path.isdir(args.run_dir):
        print(f"error: not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    if args.cmd == "summarize":
        data = summarize(args.run_dir)
        return 0 if data["n_span_records"] else 1
    out_path = args.out or os.path.join(args.run_dir, "trace.json")
    n = export_trace(args.run_dir, out_path)
    print(f"wrote {n} events -> {out_path}")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
