"""CLI for repro_torch.analysis.

    python -m repro_torch.analysis path/to/env.py other_dir/  # your code
    python -m repro_torch.analysis --self             # the port: lint + audit
    python -m repro_torch.analysis --self --device cpu   # the audit on CPU
    python -m repro_torch.analysis tests/ --report-only  # never fails
    python -m repro_torch.analysis --self --update-baseline  # regenerate the
                                                             # baseline

``--self`` lints ``src/repro_torch`` against the committed (empty) baseline,
checks that every module of the hot-step table exists, and runs the
dispatch audit (``targets.audit_all``) on ``--device`` (``cuda`` by
default). Exit status: 0 when no non-baselined lint findings and no audit
violations; 1 otherwise (``--report-only`` always exits 0).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import lint
from repro_torch.analysis.rules import RULES, Finding

SELF_BASELINE = Path(__file__).resolve().parent / "self_baseline.json"
_SRC = Path(__file__).resolve().parents[2]   # .../src


def _missing_hot_modules() -> list:
    """A finding for each module of the hot-step table that is not there."""
    from repro_torch.analysis.targets import HOT_STEPS
    return [Finding("STALE-HOT-STEP", mod, 1, 0,
                    f"the hot-step table names module '{mod}', which does "
                    f"not exist; update analysis/targets.py::HOT_STEPS",
                    f"HOT_STEPS {mod}")
            for mod in HOT_STEPS if not (_SRC / mod).is_file()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static checks: AST lint + dispatch audit")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--self", action="store_true", dest="self_check",
                    help="gate the port: lint src/repro_torch against the "
                         "committed baseline and run the dispatch audit "
                         "(kernels, engine tiers, envs)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON of grandfathered findings")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--report-only", action="store_true",
                    help="print findings but always exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule IDs to run (default: all)")
    ap.add_argument("--no-audit", action="store_true",
                    help="with --self: skip the dispatch audit")
    ap.add_argument("--device", default=None,
                    help="where --self's audit runs: 'cuda' (default) or "
                         "'cpu'")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)

    if not args.self_check and not args.paths:
        ap.error("give paths to lint, or --self")
    paths = [_SRC / "repro_torch"] if args.self_check else args.paths
    baseline = args.baseline or (str(SELF_BASELINE) if args.self_check
                                 else None)
    rules = ([r.strip().upper() for r in args.rules.split(",")]
             if args.rules else None)

    all_findings = []
    for f in lint.iter_python_files(paths):
        all_findings.extend(lint.check_file(f, rules=rules))
    if args.self_check:
        all_findings.extend(_missing_hot_modules())

    if args.update_baseline:
        target = baseline or "analysis_baseline.json"
        lint.save_baseline(all_findings, target)
        print(f"baseline: {len(all_findings)} finding(s) -> {target}")
        return 0

    fresh = lint.apply_baseline(all_findings, lint.load_baseline(baseline))
    grandfathered = len(all_findings) - len(fresh)

    audits = []
    if args.self_check and not args.no_audit:
        from repro_torch.analysis.targets import audit_all
        audits = audit_all(device=args.device)
    violations = [v for a in audits for v in a.violations]

    report = {
        "findings": [f.to_dict() for f in fresh],
        "grandfathered": grandfathered,
        "audit": {
            "targets": len(audits),
            "passed": sum(a.ok for a in audits),
            "violations": [v.to_dict() for v in violations],
            "counts": [{"target": a.target, "syncs": a.syncs,
                        "copies": a.copies, "f64": a.f64,
                        "allowed": a.allowed} for a in audits],
        },
        "rules": {rid: r.summary for rid, r in RULES.items()},
    }
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")

    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in fresh:
            print(f.render())
        for v in violations:
            print(v.render())
        bits = [f"{len(fresh)} finding(s)"]
        if grandfathered:
            bits.append(f"{grandfathered} baselined")
        if audits:
            bits.append(f"audit {sum(a.ok for a in audits)}/{len(audits)} "
                        f"targets clean")
        print("repro_torch.analysis: " + ", ".join(bits))

    if args.report_only:
        return 0
    return 1 if (fresh or violations) else 0


if __name__ == "__main__":
    sys.exit(main())
