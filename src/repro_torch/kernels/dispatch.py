"""Kernel dispatch: one registry from op name to its implementations.

The op names are those of ``repro.kernels.dispatch`` (``OPS``). Each ported
op registers two backends:

  ``ref``   plain PyTorch — the CPU path, and the yardstick on the card
  ``cuda``  the hand-written CUDA C++ kernel — needs CUDA tensors

Selection, highest precedence first:

  1. explicit ``mode=`` at the call site
  2. a ``dispatch.using(mode)`` scope
  3. the device default — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors,
     and ``cuda`` for ``meta`` tensors, whose wrappers return outputs of
     the right shape (the dry run, ``launch/dryrun.py``) — never the
     plain version's internals; ``call`` records the kernel's work while
     a ``kernels/cost.py`` recording is open

There is no environment override and no autotune: nothing can route a CUDA
tensor to ``ref`` behind the caller's back, and asking for ``cuda`` on CPU
tensors raises.
"""
from __future__ import annotations

import contextlib
import threading
from contextlib import contextmanager
from typing import Callable, Dict

import torch

from repro_torch.kernels import cost

OPS = ("flash_attention", "flash_decode", "quant_matmul", "gae", "ssd",
       "pack")

REF = "ref"
CUDA = "cuda"
BACKENDS = (REF, CUDA)

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_TLS = threading.local()


def register(op: str, name: str):
    """Decorator: register ``fn`` as backend ``name`` of ``op``."""
    if op not in OPS:
        raise KeyError(f"unknown kernel op {op!r}; ops are {OPS}")
    if name not in BACKENDS:
        raise KeyError(f"unknown backend {name!r}; backends are {BACKENDS}")

    def deco(fn):
        _REGISTRY.setdefault(op, {})[name] = fn
        return fn
    return deco


def implementations(op: str) -> tuple:
    if not _REGISTRY:
        from repro_torch.kernels import ops  # noqa: F401 (registers ops)
    if op not in _REGISTRY:
        raise KeyError(f"kernel op {op!r} is not ported yet; ported: "
                       f"{tuple(sorted(_REGISTRY))}")
    return tuple(_REGISTRY[op])


@contextmanager
def using(mode: str):
    """Scoped backend: ``with dispatch.using("ref"): ...`` applies to every
    op call in the block that doesn't pass an explicit ``mode=``.
    Thread-local and reentrant."""
    if mode not in BACKENDS:
        raise KeyError(f"unknown backend {mode!r}; backends are {BACKENDS}")
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(mode)
    try:
        yield
    finally:
        stack.pop()


@contextmanager
def replaced(op: str, name: str, fn: Callable):
    """Backend ``name`` of ``op`` is ``fn`` inside the block, for every
    thread: a measurement's way to run one op differently (another
    precision, a held forward) through the unchanged model code. The
    registered backend comes back on exit."""
    if name not in implementations(op):
        raise KeyError(f"{op}: no backend {name!r} to replace")
    saved, _REGISTRY[op][name] = _REGISTRY[op][name], fn
    try:
        yield
    finally:
        _REGISTRY[op][name] = saved


def scope():
    """The innermost ``using`` mode of this thread, or None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def recompute_context():
    """``context_fn`` of ``torch.utils.checkpoint``: (the forward's context,
    the recomputation's). Autograd runs a CUDA graph's backward, and so a
    checkpoint's recomputation, on a thread of its own, where this thread's
    ``using`` scope does not reach: the recomputation re-enters the scope
    the forward ran under, so that both take the same backend (and save
    the same tensors)."""
    mode = scope()
    return (contextlib.nullcontext(),
            using(mode) if mode else contextlib.nullcontext())


def resolve(op: str, device: torch.device, mode: str = None) -> str:
    """Pick the backend for ``op`` on tensors that live on ``device``."""
    names = implementations(op)
    if mode is None:
        mode = scope() or (CUDA if device.type in ("cuda", "meta")
                           else REF)
    if mode not in names:
        raise KeyError(f"{op}: no backend {mode!r}; have {names}")
    if mode == CUDA and device.type not in ("cuda", "meta"):
        raise RuntimeError(f"{op}: backend 'cuda' needs CUDA tensors, got "
                           f"tensors on {device}")
    return mode


def call(op: str, *args, mode: str = None, **kwargs):
    """Resolve on the first tensor argument's device (the first element's,
    where that argument is a list of tensors) and invoke."""
    first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
    name = resolve(op, first.device, mode)
    if cost.recording_open():
        # an op count is open (launch/op_analysis.py): the call is one unit
        # of its kernel's work, whatever the backend does inside
        work = cost.kernel_work(op, args, kwargs)
        with cost.opaque():
            out = _REGISTRY[op][name](*args, **kwargs)
        cost.record(op, *work)
        return out
    return _REGISTRY[op][name](*args, **kwargs)
