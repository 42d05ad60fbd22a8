"""Layer 1: run the AST rules over files, honoring ``# repro_torch:
noqa[RULE]`` suppressions and a committed baseline of grandfathered
findings. The counterpart of ``repro/analysis/lint.py``.

Library API::

    from repro_torch import analysis
    findings = analysis.check_file("my_env.py")
    findings = analysis.check_paths(["src/"], baseline="baseline.json")

Suppression is per-line: a ``# repro_torch: noqa[HOST-SYNC]`` comment on the
flagged line silences that rule there (bare ``# repro_torch: noqa`` silences
all rules on the line); the port's own suppressions give their reason on
the line. The baseline file is a JSON multiset of finding keys
``path::RULE::normalized-snippet`` with counts — keyed on content, not line
numbers, so unrelated edits above a grandfathered finding don't resurrect
it.

Hot steps (``rules.py``): ``check_source`` takes them from ``hot=``, or else
from ``analysis/targets.py::HOT_STEPS`` by the file's path.
"""
from __future__ import annotations

import ast
import json
import re
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Union

from repro_torch.analysis.rules import RULES, Finding, build_context

_NOQA = re.compile(r"#\s*repro_torch:\s*noqa(?:\[([A-Za-z0-9_\-, ]+)\])?")


def _noqa_rules_for_line(line: str) -> Optional[set]:
    """None → no noqa; empty set → all rules suppressed; else rule IDs."""
    m = _NOQA.search(line)
    if not m:
        return None
    if m.group(1) is None:
        return set()
    return {r.strip().upper() for r in m.group(1).split(",") if r.strip()}


def hot_steps_for(path: str) -> Set[str]:
    """The hot-step qualnames ``HOT_STEPS`` names for the module at
    ``path`` (matched on the path's tail, ``repro_torch/…/x.py``)."""
    from repro_torch.analysis.targets import HOT_STEPS
    p = Path(path).as_posix()
    for mod, names in HOT_STEPS.items():
        if p == mod or p.endswith("/" + mod):
            return set(names)
    return set()


def check_source(source: str, path: str = "<string>",
                 rules: Optional[Iterable[str]] = None,
                 hot: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint python source text. ``rules`` limits to a subset of rule IDs;
    ``hot``: the qualnames of its hot steps (default: the table's)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("SYNTAX", path, e.lineno or 1, e.offset or 0,
                        f"cannot parse: {e.msg}", "")]
    ctx = build_context(tree, source, path,
                        set(hot) if hot is not None else hot_steps_for(path))
    wanted = set(rules) if rules is not None else set(RULES)
    findings: List[Finding] = []
    for rule_id, rule in RULES.items():
        if rule_id in wanted:
            findings.extend(rule.fn(ctx))
    kept = []
    for f in findings:
        if 1 <= f.line <= len(ctx.lines):
            suppressed = _noqa_rules_for_line(ctx.lines[f.line - 1])
            if suppressed is not None and \
                    (not suppressed or f.rule in suppressed):
                continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def check_file(path: Union[str, Path],
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    p = Path(path)
    return check_source(p.read_text(), str(p), rules=rules)


def iter_python_files(paths: Sequence[Union[str, Path]]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


# ---------------------------------------------------------------------------
# baseline

def _key_str(f: Finding) -> str:
    path, rule, snippet = f.key()
    return f"{path}::{rule}::{snippet}"


def load_baseline(path: Union[str, Path, None]) -> Counter:
    if path is None or not Path(path).exists():
        return Counter()
    data = json.loads(Path(path).read_text())
    return Counter({k: int(v) for k, v in data.get("findings", {}).items()})


def save_baseline(findings: Sequence[Finding], path: Union[str, Path]
                  ) -> None:
    counts = Counter(_key_str(f) for f in findings)
    payload = {"comment": "grandfathered repro_torch.analysis findings — "
                          "regenerate with `python -m repro_torch.analysis "
                          "--self --update-baseline`",
               "findings": dict(sorted(counts.items()))}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline: Counter) -> List[Finding]:
    """Drop findings covered by the baseline multiset (count-aware)."""
    budget = Counter(baseline)
    fresh: List[Finding] = []
    for f in findings:
        k = _key_str(f)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            fresh.append(f)
    return fresh


def check_paths(paths: Sequence[Union[str, Path]],
                baseline: Union[str, Path, None] = None,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint all python files under ``paths``; subtract the baseline."""
    findings: List[Finding] = []
    for p in iter_python_files(paths):
        findings.extend(check_file(p, rules=rules))
    return apply_baseline(findings, load_baseline(baseline))
