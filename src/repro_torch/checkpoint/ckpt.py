"""Checkpoints with atomic commit and async save.

The counterpart of ``repro/checkpoint/ckpt.py``, with its on-disk layout:
one ``.npy`` per shard plus ``index.json`` recording global shapes, dtypes
and each shard's global slice. An unsharded tree is written as one
whole-array shard a leaf (``<name>.full.npy``). A tree laid out on a mesh
(``save(..., shardings=)``, a matching tree of
``distributed.sharding.NamedSharding``) is written by every rank: each
writes its own blocks (``<name>.<rank>.npy``), a block that several ranks
hold once, by the first of them (``NamedSharding.writes``), then a marker
file; rank 0 waits for every rank's marker, writes ``index.json`` (every
rank's slices follow from the shardings) and commits. ``restore(...,
shardings=)`` assembles each rank's region from whatever shards exist,
as the reference's ``read_region`` does, so a checkpoint restores onto
any mesh, and an unsharded one onto a mesh.
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
import time
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


def _ranks(shardings):
    """(this rank, world size) of a sharded save."""
    torch = _torch_mod()
    dist = torch.distributed if torch is not None else None
    if dist is not None and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    leaf = next(s for _, s in _flatten_with_names(shardings))
    return 0, leaf.mesh.size


def _global_shape(local_shape, sharding):
    """The global shape of a block of ``local_shape`` laid out by
    ``sharding`` (each split dim times its ranks)."""
    sizes = sharding.mesh.shape
    out = []
    for n, part in zip(local_shape, tuple(sharding.spec) +
                       (None,) * len(local_shape)):
        axes = () if part is None else \
            (part if isinstance(part, tuple) else (part,))
        k = 1
        for a in axes:
            k *= sizes[a]
        out.append(int(n) * k)
    return out


MARKER_WAIT_S = 600.0     # rank 0 waits this long for the others' shards


def save(directory: str, tree, step: Optional[int] = None,
         async_: bool = False, keep: Optional[int] = 3, shardings=None):
    """Save ``tree``. Returns the committed path (or a join handle if
    async). ``keep=None`` disables GC — every step is kept. With
    ``shardings`` every rank of the mesh calls ``save`` with its blocks;
    rank 0's call (or its handle) returns once every rank's shards are
    written and the checkpoint is committed, the other ranks' once it is
    committed."""
    named = _flatten_with_names(tree)
    step = int(step if step is not None else _next_step(directory))
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    rank, world = 0, 1
    sh_leaves = None
    if shardings is not None:
        rank, world = _ranks(shardings)
        sh_leaves = [s for _, s in _flatten_with_names(shardings)]

    # synchronous device→host snapshot: the values at this call
    with _span("ckpt.snapshot"):
        shards = []
        index = {"arrays": {}, "step": step}
        for i, (name, leaf) in enumerate(named):
            shape = list(leaf.shape) if hasattr(leaf, "shape") \
                else list(np.shape(leaf))
            base = name.replace('/', '.')
            if sh_leaves is None:
                fn = f"{base}.full.npy"
                index["arrays"][name] = {
                    "shape": shape, "dtype": _dtype_name(leaf),
                    "shards": [{"file": fn, "slice": _slice_spec(shape)}]}
                shards.append((fn, _to_host(leaf)))
                continue
            sh = sh_leaves[i]
            gshape = _global_shape(shape, sh)
            entry = {"shape": gshape, "dtype": _dtype_name(leaf),
                     "shards": []}
            for r in range(world):
                if sh.writes(r):
                    entry["shards"].append({"file": f"{base}.{r}.npy",
                                            "slice": _region(sh, gshape, r)})
            index["arrays"][name] = entry
            if sh.writes(rank):
                shards.append((f"{base}.{rank}.npy", _to_host(leaf)))

    def _write():
        with _span("ckpt.write"):
            os.makedirs(tmp, exist_ok=True)
            for fn, arr in shards:
                with open(os.path.join(tmp, fn), "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
            if world > 1:
                marker = os.path.join(tmp, f"rank{rank}.done")
                open(marker, "w").close()
                if rank != 0:
                    _wait_commit(marker, final)
                    return
                _wait_markers(tmp, world)
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


def _region(sharding, gshape, rank):
    return [[s.start or 0, n if s.stop is None else s.stop]
            for s, n in zip(sharding.index(gshape, rank), gshape)]


def _wait_markers(tmp: str, world: int):
    """Rank 0 of a sharded save: wait for every rank's marker, then drop
    them."""
    names = [os.path.join(tmp, f"rank{r}.done") for r in range(world)]
    t0 = time.monotonic()
    while not all(os.path.exists(n) for n in names):
        if time.monotonic() - t0 > MARKER_WAIT_S:
            missing = [r for r, n in enumerate(names) if not os.path.exists(n)]
            raise TimeoutError(f"ranks {missing} wrote no shards to {tmp} in "
                               f"{MARKER_WAIT_S:.0f} s")
        time.sleep(0.01)
    for n in names:
        os.remove(n)


def _wait_commit(marker: str, final: str):
    """A rank past 0 of a sharded save: wait until rank 0 has taken this
    rank's marker and committed, so that a restore on any rank after its
    ``save`` returned reads the new checkpoint."""
    t0 = time.monotonic()
    while os.path.exists(marker) or not os.path.exists(
            os.path.join(final, "index.json")):
        if time.monotonic() - t0 > MARKER_WAIT_S:
            raise TimeoutError(f"rank 0 did not commit {final} in "
                               f"{MARKER_WAIT_S:.0f} s")
        time.sleep(0.01)


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


def restore(path_or_dir: str, like, shardings=None):
    """Restore into the structure of ``like``: a committed checkpoint
    directory, or a directory of them (its newest). Each tensor leaf of
    ``like`` comes back as a tensor on that leaf's device, each numpy leaf
    as a numpy array, in the saved dtype. With ``shardings`` (a matching
    tree of ``NamedSharding``) each leaf is this rank's region of the
    saved global array, assembled from whatever shards hold it."""
    with _span("ckpt.restore"):
        return _restore(path_or_dir, like, shardings)


def _read_region(path: str, entry: dict, region) -> np.ndarray:
    """The global slice ``region`` ([[start, stop], ...]) of an array,
    assembled from the saved shards that overlap it. Raw dtypes (bf16,
    stored as bytes) are read as 2-byte words."""
    raw = entry["dtype"] in _RAW
    dtype = np.dtype(np.uint16) if raw else np.dtype(entry["dtype"])
    out = np.zeros([b - a for a, b in region], dtype)
    for sh in entry["shards"]:
        src, dst = [], []
        for (ws, we), (ss, se) in zip(region, sh["slice"]):
            lo, hi = max(ws, ss), min(we, se)
            if lo >= hi:
                break
            src.append(slice(lo - ss, hi - ss))
            dst.append(slice(lo - ws, hi - ws))
        else:
            data = np.load(os.path.join(path, sh["file"]))
            if raw:
                data = data.view(np.uint16).reshape(
                    [b - a for a, b in sh["slice"]])
            out[tuple(dst)] = data.reshape(
                [b - a for a, b in sh["slice"]])[tuple(src)].astype(
                    dtype, copy=False)
    return out


def _restore(path_or_dir: str, like, shardings=None):
    path = path_or_dir
    if not os.path.exists(os.path.join(path, "index.json")):
        path = latest(path_or_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {path_or_dir}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)

    sh_leaves = None if shardings is None else \
        [s for _, s in _flatten_with_names(shardings)]
    out = []
    for i, (name, leaf) in enumerate(_flatten_with_names(like)):
        if name not in index["arrays"]:
            raise KeyError(f"checkpoint {path} has no array {name!r}")
        entry = index["arrays"][name]
        gshape = tuple(entry["shape"])
        region = [[0, n] for n in gshape]
        if sh_leaves is not None:
            region = _region(sh_leaves[i], gshape, None)
        shape = tuple(b - a for a, b in region)
        want = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(np.shape(leaf))
        if shape != want:
            raise ValueError(f"{name}: checkpoint shape {shape} (of the "
                             f"global {gshape}), expected {want}")
        arr = _read_region(path, entry, region)
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
