"""Checkpoints with atomic commit and async save.

The counterpart of ``repro/checkpoint/ckpt.py``, with its on-disk layout:
one ``.npy`` per array plus ``index.json`` recording shapes, dtypes and each
shard's global slice (here one whole-array shard, ``<name>.full.npy``).
Leaf names follow the reference's key paths — dict keys (sorted), NamedTuple
field names, tuple indices, joined by ``/`` — so a tree of the same
structure saved by either package restores in the other.

Commit protocol: write into ``<dir>/step_N.tmp``, fsync, atomic rename to
``<dir>/step_N`` — a crash mid-save never corrupts the latest checkpoint.
``latest()`` returns the newest committed step. Async mode copies every
tensor to the host synchronously, at the call, and writes on a background
thread: the port's state is mutable, so a thread that held the live tensors
would write later values.

bfloat16 has no numpy dtype here: it is stored as its raw bytes (uint8, the
last axis doubled) under the dtype name ``"bfloat16"``, as the reference
stores its custom dtypes, and restored bit for bit.

The tree is nested dicts, NamedTuples, tuples and lists whose leaves are
tensors or numpy arrays; ``None`` holds no leaf. The module imports no torch
at its top (it is torch-free until a tensor reaches it).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
from typing import Optional

import numpy as np

from repro_torch.telemetry import span as _span

_RAW = {"bfloat16"}      # dtypes numpy lacks: stored as raw uint8 bytes


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node):
    """Children of an inner node as (key, child), in the reference's
    flatten order (dict keys sorted)."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    return list(enumerate(node))


def _is_inner(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] in flatten order; ``None`` contributes nothing."""
    if tree is None:
        return []
    if not _is_inner(tree):
        return [("/".join(str(k) for k in prefix), tree)]
    out = []
    for k, child in _items(tree):
        out.extend(_flatten_with_names(child, prefix + (k,)))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in flatten order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if not _is_inner(like):
        return next(leaves)
    if isinstance(like, dict):
        built = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    kids = [_unflatten(c, leaves) for _, c in _items(like)]
    if _is_namedtuple(like):
        return type(like)(*kids)
    return type(like)(kids)


def _torch_mod():
    return sys.modules.get("torch")


def _is_tensor(x) -> bool:
    t = _torch_mod()
    return t is not None and isinstance(x, t.Tensor)


def _dtype_name(x) -> str:
    if _is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _to_host(x) -> np.ndarray:
    """A host copy of one leaf, made now: tensors go through ``.cpu()``
    (a copy even on the CPU), bfloat16 as its raw bytes."""
    if _is_tensor(x):
        t = x.detach()
        if str(t.dtype).replace("torch.", "") in _RAW:
            t = t.reshape(-1 if t.dim() == 0 else t.shape)
            t = t.contiguous().view(_torch_mod().uint8)
        return t.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _slice_spec(shape):
    return [[0, int(n)] for n in shape]


def save(directory: str, tree, step: Optional[int] = None,
         async_: bool = False, keep: Optional[int] = 3):
    """Save ``tree``. Returns the committed path (or a join handle if
    async). ``keep=None`` disables GC — every step is kept."""
    named = _flatten_with_names(tree)
    step = int(step if step is not None else _next_step(directory))
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"

    # synchronous device→host snapshot: the values at this call
    with _span("ckpt.snapshot"):
        shards = []
        index = {"arrays": {}, "step": step}
        for name, leaf in named:
            shape = list(leaf.shape) if hasattr(leaf, "shape") \
                else list(np.shape(leaf))
            arr = _to_host(leaf)
            fn = f"{name.replace('/', '.')}.full.npy"
            index["arrays"][name] = {
                "shape": shape, "dtype": _dtype_name(leaf),
                "shards": [{"file": fn, "slice": _slice_spec(shape)}]}
            shards.append((fn, arr))

    def _write():
        with _span("ckpt.write"):
            os.makedirs(tmp, exist_ok=True)
            for fn, arr in shards:
                with open(os.path.join(tmp, fn), "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic commit
            if keep is not None:
                _gc(directory, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return final


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def _next_step(directory: str) -> int:
    s = _steps(directory)
    return (s[-1] + 1) if s else 0


def latest(directory: str) -> Optional[str]:
    s = _steps(directory)
    return os.path.join(directory, f"step_{s[-1]}") if s else None


def step_of(path: str) -> int:
    """The step a committed checkpoint was saved at, from its own
    ``index.json``, falling back to the ``step_N`` basename. Never parses
    the surrounding directory path."""
    try:
        with open(os.path.join(path, "index.json")) as f:
            step = json.load(f).get("step")
        if step is not None:
            return int(step)
    except (OSError, ValueError):
        pass
    base = os.path.basename(os.path.normpath(path))
    if base.startswith("step_"):
        try:
            return int(base[len("step_"):])
        except ValueError:
            pass
    raise ValueError(
        f"cannot determine the step of checkpoint {path!r}: no 'step' in "
        f"index.json and basename is not of the form step_<N>")


def _gc(directory: str, keep: int):
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def restore(path_or_dir: str, like):
    """Restore into the structure of ``like``: a committed checkpoint
    directory, or a directory of them (its newest). Each tensor leaf of
    ``like`` comes back as a tensor on that leaf's device, each numpy leaf
    as a numpy array, in the saved dtype."""
    with _span("ckpt.restore"):
        return _restore(path_or_dir, like)


def _read(path: str, entry: dict) -> np.ndarray:
    shape = tuple(entry["shape"])
    name = entry["dtype"]
    out = None
    for sh in entry["shards"]:
        data = np.load(os.path.join(path, sh["file"]))
        if name in _RAW:
            out = data                           # raw bytes, one shard
            continue
        if out is None:
            out = np.zeros(shape, np.dtype(name))
        out[tuple(slice(a, b) for a, b in sh["slice"])] = \
            data.astype(out.dtype, copy=False)
    return out


def _restore(path_or_dir: str, like):
    path = path_or_dir
    if not os.path.exists(os.path.join(path, "index.json")):
        path = latest(path_or_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {path_or_dir}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)

    out = []
    for name, leaf in _flatten_with_names(like):
        if name not in index["arrays"]:
            raise KeyError(f"checkpoint {path} has no array {name!r}")
        entry = index["arrays"][name]
        shape = tuple(entry["shape"])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(np.shape(leaf))
        if shape != want:
            raise ValueError(f"{name}: checkpoint shape {shape}, expected "
                             f"{want}")
        arr = _read(path, entry)
        if _is_tensor(leaf):
            torch = _torch_mod()
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if entry["dtype"] in _RAW:
                t = t.view(getattr(torch, entry["dtype"]))
            out.append(t.reshape(shape).to(leaf.device))
        else:
            if entry["dtype"] in _RAW:
                raise TypeError(f"{name}: {entry['dtype']} restores into a "
                                f"tensor, not a numpy array")
            out.append(arr.reshape(shape))
    return _unflatten(like, iter(out))
