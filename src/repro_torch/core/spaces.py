"""Observation/action space trees (Gym/Gymnasium `spaces` analogue): a copy
of ``repro/core/spaces.py``, with ``sample`` drawing from a
``torch.Generator``.

The module imports numpy only: the host pool's spawned workers import it,
and must not pay for torch. ``torch_dtype`` and ``sample`` import torch
where they run.

PufferLib's emulation layer operates on arbitrarily nested space trees. We
define a minimal, hashable space algebra that covers what the paper handles:
Box / Discrete / MultiDiscrete leaves composed by Dict / Tuple nodes.

Spaces are static metadata: the flattening specs derived from them are
computed once, host-side (mirroring the paper's "shape checks only at
startup").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np


def _canon_dtype(dtype):
    """Canonical numpy scalar type for a leaf dtype, so two structurally
    identical spaces compare equal whatever alias built them."""
    return np.dtype(dtype).type


class Space:
    pass


@dataclass(frozen=True)
class Discrete(Space):
    n: int
    dtype: Any = np.int32

    def __post_init__(self):
        object.__setattr__(self, "dtype", _canon_dtype(self.dtype))


@dataclass(frozen=True)
class MultiDiscrete(Space):
    nvec: tuple
    dtype: Any = np.int32

    def __post_init__(self):
        object.__setattr__(self, "nvec", tuple(int(n) for n in self.nvec))
        object.__setattr__(self, "dtype", _canon_dtype(self.dtype))


@dataclass(frozen=True)
class Box(Space):
    shape: tuple
    dtype: Any = np.float32
    low: float = -np.inf
    high: float = np.inf

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", _canon_dtype(self.dtype))


@dataclass(frozen=True)
class Dict(Space):
    spaces: tuple  # ((key, space), ...) canonically sorted by key

    def __init__(self, spaces: Mapping[str, Space]):
        # Canonical key order — the paper sorts agent/space keys so that
        # packed layouts are deterministic across processes.
        object.__setattr__(
            self, "spaces", tuple(sorted(spaces.items(), key=lambda kv: kv[0])))

    def items(self):
        return self.spaces


@dataclass(frozen=True)
class Tuple(Space):
    spaces: tuple

    def __init__(self, spaces: Sequence[Space]):
        object.__setattr__(self, "spaces", tuple(spaces))


# ---------------------------------------------------------------------------

def leaves(space: Space, path: tuple = ()):
    """Depth-first (path, leaf_space) pairs in canonical order."""
    if isinstance(space, Dict):
        for k, sub in space.items():
            yield from leaves(sub, path + (k,))
    elif isinstance(space, Tuple):
        for i, sub in enumerate(space.spaces):
            yield from leaves(sub, path + (i,))
    else:
        yield path, space


def leaf_shape(space: Space) -> tuple:
    if isinstance(space, Discrete):
        return ()
    if isinstance(space, MultiDiscrete):
        return (len(space.nvec),)
    if isinstance(space, Box):
        return space.shape
    raise TypeError(space)


def leaf_dtype(space: Space):
    return np.dtype(space.dtype)


def torch_dtype(np_dtype):
    """numpy dtype of a space leaf → torch dtype."""
    import torch
    return torch.from_numpy(np.zeros((), np_dtype)).dtype


def zeros(space: Space):
    """A zero element of the space as a nested dict/tuple. Leaves are numpy;
    the only consumers (``unemulate`` / ``unemulate_action``) overwrite every
    leaf anyway."""
    if isinstance(space, Dict):
        return {k: zeros(s) for k, s in space.items()}
    if isinstance(space, Tuple):
        return tuple(zeros(s) for s in space.spaces)
    return np.zeros(leaf_shape(space), leaf_dtype(space))


def sample(space: Space, generator, batch: tuple = ()):
    """Random element (uniform over the space) with leading ``batch`` dims,
    drawn from ``generator`` (a ``torch.Generator``) on its device — used in
    tests/mocks. Leaves are tensors of the leaf dtype."""
    import torch
    dev = generator.device
    if isinstance(space, Dict):
        return {k: sample(s, generator, batch) for k, s in space.items()}
    if isinstance(space, Tuple):
        return tuple(sample(s, generator, batch) for s in space.spaces)
    dtype = torch_dtype(leaf_dtype(space))
    if isinstance(space, Discrete):
        return torch.randint(0, space.n, batch, generator=generator,
                             device=dev, dtype=dtype)
    if isinstance(space, MultiDiscrete):
        u = torch.rand(batch + (len(space.nvec),), generator=generator,
                       device=dev)
        nvec = torch.tensor(space.nvec, dtype=torch.float32, device=dev)
        return (u * nvec).to(dtype)
    if isinstance(space, Box):
        lo = 0.0 if not np.isfinite(space.low) else space.low
        hi = 1.0 if not np.isfinite(space.high) else space.high
        x = torch.rand(batch + space.shape, generator=generator, device=dev)
        return (lo + (hi - lo) * x).to(dtype)
    raise TypeError(space)


def get_path(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def set_path(tree, path: tuple, value):
    """Functional set — rebuilds nested dict/tuple containers."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        out = dict(tree)
        out[head] = set_path(tree[head], rest, value)
        return out
    if isinstance(tree, tuple):
        out = list(tree)
        out[head] = set_path(tree[head], rest, value)
        return tuple(out)
    raise TypeError(tree)


def num_actions(space: Space) -> tuple:
    """Flatten an action space tree to a single MultiDiscrete nvec — the
    paper's action emulation. Continuous action leaves are handled separately
    (beyond-paper; see emulation.ContinuousActionHead)."""
    nvec = []
    for _, leaf in leaves(space):
        if isinstance(leaf, Discrete):
            nvec.append(leaf.n)
        elif isinstance(leaf, MultiDiscrete):
            nvec.extend(leaf.nvec)
        else:
            raise TypeError(
                f"discrete action emulation got {leaf}; use continuous head")
    return tuple(nvec)
