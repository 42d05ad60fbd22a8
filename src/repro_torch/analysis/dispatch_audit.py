"""Layer 2: run-and-inspect audit of what a call makes the host wait for.

The counterpart of ``repro/analysis/jaxpr_audit.py``. The reference traces
a function and reads its jaxpr and compiled HLO; the port runs eagerly and
has neither, so this layer runs one call under ``SyncDetector`` and counts
what would stall the host behind the card:

  * **host syncs** — an op whose result the host must read before it can
    go on: ``aten._local_scalar_dense`` (``.item()``, ``float(t)``,
    ``int(t)``, ``bool(t)``, an ``if`` on a tensor), an op whose output
    shape depends on the data (``nonzero``, ``masked_select``, an index or
    index update by a boolean mask), and the Python-level reads that
    dispatch no aten op on a CPU tensor: ``.tolist()``, ``.numpy()``,
    ``.cpu()`` and ``__array__`` (``np.asarray(t)``), caught by a scoped
    patch of ``torch.Tensor`` (on the CPU ``.numpy()`` shows only an
    ``aten.detach``, so a dispatch mode alone would miss all four). On
    ``cuda`` the detector also sets ``torch.cuda.set_sync_debug_mode
    ("error")``, so a sync it does not name raises;
  * **device-to-host copies** — a ``_to_copy`` or ``copy_`` from a CUDA
    tensor into host memory;
  * **f32→f64 promotions** — an op that produces a float64 tensor in a call
    given no float64 input. ``allow_f64`` records them with a reason where
    f64 is the design (``analysis/targets.py``), and they stay in the
    counts.

The reference's retrace and donation checks have no eager counterpart (no
trace cache, no buffer donation). Entry point: :func:`audit_fn`; the repo's
targets are in ``analysis/targets.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops whose result the host must read (or whose output size depends on the
# data, which the host must learn before it can allocate)
SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select"}
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
_COPY_OPS = {"_to_copy", "copy_"}
# Python-level reads that dispatch no aten op on a CPU tensor
_PATCHED = ("tolist", "numpy", "cpu", "__array__")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bool_index(args) -> bool:
    """An index (or index update) by a boolean mask: its size is the mask's
    count of True, which the host must read."""
    indices = args[1] if len(args) > 1 else ()
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in (indices or ()))


class SyncDetector(TorchDispatchMode):
    """While entered, records every host sync, device-to-host copy and f64
    result of the torch code that runs (``syncs``, ``copies``, ``f64``: one
    string each, naming the op). ``f64_inputs`` True: the caller gave f64
    inputs, so an f64 result is no promotion. On a CUDA ``device`` the card
    raises at a sync too (``set_sync_debug_mode("error")``)."""

    def __init__(self, device=None, f64_inputs: bool = False):
        super().__init__()
        self.device = torch.device(device) if device is not None else None
        self.f64_inputs = f64_inputs
        self.syncs: List[str] = []
        self.copies: List[str] = []
        self.f64: List[str] = []
        self._inside = 0            # in a patched method: its ops are its own
        self._saved = {}
        self._debug = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        name = func.overloadpacket.__name__
        if name in SYNC_OPS or (name in _INDEX_OPS and _bool_index(args)):
            self.syncs.append(f"aten.{name}")
        if name in _COPY_OPS:
            src = args[1] if name == "copy_" else args[0]
            dst = args[0] if name == "copy_" else out
            if isinstance(src, torch.Tensor) and src.device.type == "cuda" \
                    and dst.device.type == "cpu":
                self.copies.append(f"aten.{name}")
        if not self.f64_inputs and any(
                t.dtype == torch.float64 for t in _tensors(out)):
            self.f64.append(f"aten.{name}")
        return out

    def _patch(self):
        detector = self

        def wrap(meth, real):
            def patched(t, *a, **kw):
                if not detector._inside:
                    detector.syncs.append(f"Tensor.{meth}")
                    if meth == "cpu" and t.device.type == "cuda":
                        detector.copies.append("Tensor.cpu")
                detector._inside += 1
                try:
                    return real(t, *a, **kw)
                finally:
                    detector._inside -= 1
            return patched

        for meth in _PATCHED:
            real = getattr(torch.Tensor, meth)
            self._saved[meth] = real
            setattr(torch.Tensor, meth, wrap(meth, real))

    def __enter__(self):
        self._patch()
        if self.device is not None and self.device.type == "cuda":
            self._debug = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._debug is not None:
                torch.cuda.set_sync_debug_mode(self._debug)
                self._debug = None
            for meth, real in self._saved.items():
                setattr(torch.Tensor, meth, real)
            self._saved = {}


@dataclass(frozen=True)
class AuditViolation:
    check: str       # host-sync | d2h-copy | f64-promotion | run | coverage
    target: str
    message: str

    def render(self) -> str:
        return f"[{self.check}] {self.target}: {self.message}"

    def to_dict(self) -> dict:
        return {"check": self.check, "target": self.target,
                "message": self.message}


@dataclass
class AuditResult:
    target: str
    checks: List[str] = field(default_factory=list)
    violations: List[AuditViolation] = field(default_factory=list)
    syncs: int = 0
    copies: int = 0
    f64: int = 0
    allowed: str = ""              # why this target's f64 is the design

    @property
    def ok(self) -> bool:
        return not self.violations

    def counts(self) -> str:
        note = f" (allowed: {self.allowed})" if self.allowed else ""
        return (f"{self.target}: syncs {self.syncs}, copies {self.copies}, "
                f"f64 {self.f64}{note}")


def _first(hits: list, n: int = 3) -> str:
    return ", ".join(sorted(set(hits))[:n])


def audit_fn(fn: Callable, args: Sequence[Any] = (), *,
             name: Optional[str] = None, device=None,
             allow_f64: str = "", warmup: bool = True) -> AuditResult:
    """Run ``fn(*args)`` under ``SyncDetector`` and audit it: no host sync,
    no device-to-host copy, and no f64 result unless an argument is f64 or
    ``allow_f64`` gives the reason it is the design. ``device``: where the
    call runs (a CUDA device also errors at any sync). With ``warmup`` a
    first call runs outside the audit: it loads the kernels and builds
    per-device constants once (a host-to-device copy), which no later step
    repeats. A call that raises is a violation, never a crash."""
    target = name or getattr(fn, "__name__", repr(fn))
    res = AuditResult(target=target,
                      checks=["host-sync", "d2h-copy", "f64-promotion"])
    f64_in = any(t.dtype == torch.float64 for t in _tensors(list(args)))
    det = SyncDetector(device, f64_inputs=f64_in)
    try:
        if warmup:
            fn(*args)
        with det:
            fn(*args)
    except Exception as e:      # noqa: BLE001 — a raise is the finding
        res.violations.append(AuditViolation(
            "run", target, f"raised under the sync detector: "
                           f"{type(e).__name__}: {e}"))
    res.syncs, res.copies, res.f64 = (len(det.syncs), len(det.copies),
                                      len(det.f64))
    if det.syncs:
        res.violations.append(AuditViolation(
            "host-sync", target,
            f"{len(det.syncs)} host sync(s) ({_first(det.syncs)}): the host "
            f"waits for the card at each, serialising dispatch"))
    if det.copies:
        res.violations.append(AuditViolation(
            "d2h-copy", target,
            f"{len(det.copies)} device-to-host cop(ies) "
            f"({_first(det.copies)})"))
    if det.f64:
        if allow_f64:
            res.allowed = allow_f64
        else:
            res.violations.append(AuditViolation(
                "f64-promotion", target,
                f"{len(det.f64)} float64 result(s) ({_first(det.f64)}) with "
                f"no float64 input: doubles the bytes moved and falls off "
                f"the fast path silently"))
    return res
