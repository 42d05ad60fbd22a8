"""repro_torch.analysis — static and run-time checks of the port, its envs
and its steps: the counterpart of ``repro/analysis``.

Two layers:

  * **AST lint** (zero execution, ``rules.py``, ``lint.py``): host syncs,
    unseeded draws and telemetry in the port's hot steps (named in
    ``targets.py::HOT_STEPS``), and blocking calls without a timeout.
  * **dispatch audit** (run once, ``dispatch_audit.py``, ``targets.py``):
    each kernel op, engine tier and Ocean env step under a sync detector —
    no host sync, no device-to-host copy, no silent f32→f64 promotion.

CLI: ``python -m repro_torch.analysis [paths | --self] [--format json]``.
"""
from repro_torch.analysis.dispatch_audit import (AuditResult, AuditViolation,
                                                 SyncDetector, audit_fn)
from repro_torch.analysis.lint import (apply_baseline, check_file,
                                       check_paths, check_source,
                                       load_baseline, save_baseline)
from repro_torch.analysis.rules import RULES, Finding, Rule
from repro_torch.analysis.targets import (HOT_STEPS, audit_all,
                                          audit_engine_tiers,
                                          audit_kernel_ops, audit_ocean_envs)

__all__ = [
    "AuditResult", "AuditViolation", "SyncDetector", "audit_fn",
    "apply_baseline", "check_file", "check_paths", "check_source",
    "load_baseline", "save_baseline", "RULES", "Finding", "Rule",
    "HOT_STEPS", "audit_all", "audit_engine_tiers", "audit_kernel_ops",
    "audit_ocean_envs",
]
