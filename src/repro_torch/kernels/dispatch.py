"""Kernel dispatch: one registry from op name to its implementations.

The op names are those of ``repro.kernels.dispatch`` (``OPS``). Each ported
op registers two backends:

  ``ref``   plain PyTorch — the CPU path, and the yardstick on the card
  ``cuda``  the hand-written CUDA C++ kernel — needs CUDA tensors

Selection, highest precedence first:

  1. explicit ``mode=`` at the call site
  2. a ``dispatch.using(mode)`` scope
  3. the device default — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors

There is no environment override and no autotune: nothing can route a CUDA
tensor to ``ref`` behind the caller's back, and asking for ``cuda`` on CPU
tensors raises.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict

import torch

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


def resolve(op: str, device: torch.device, mode: str = None) -> str:
    """Pick the backend for ``op`` on tensors that live on ``device``."""
    names = implementations(op)
    if mode is None:
        stack = getattr(_TLS, "stack", None)
        mode = stack[-1] if stack else (CUDA if device.type == "cuda"
                                        else REF)
    if mode not in names:
        raise KeyError(f"{op}: no backend {mode!r}; have {names}")
    if mode == CUDA and device.type != "cuda":
        raise RuntimeError(f"{op}: backend 'cuda' needs CUDA tensors, got "
                           f"tensors on {device}")
    return mode


def call(op: str, *args, mode: str = None, **kwargs):
    """Resolve on the first tensor argument's device (the first element's,
    where that argument is a list of tensors) and invoke."""
    first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
    name = resolve(op, first.device, mode)
    return _REGISTRY[op][name](*args, **kwargs)
