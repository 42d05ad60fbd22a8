"""Static packing specs for emulation: a copy of ``repro/core/emuspec.py``.

``FlatSpec`` / ``ActionSpec`` are pure layout metadata: which leaf of a
space tree lands at which offset of the flat buffer. They are computed once,
host-side, with numpy only; ``core/emulation.py`` applies them to tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core import spaces as sp


@dataclass(frozen=True)
class LeafSpec:
    path: tuple
    shape: tuple
    dtype: Any
    offset: int          # element offset (mode units) into the flat buffer
    size: int            # element count (mode units)


@dataclass(frozen=True)
class FlatSpec:
    """Static packing plan for one space tree (computed once, host-side)."""
    space: sp.Space
    mode: str            # "f32" | "bytes"
    leaf_specs: tuple
    total: int

    @property
    def dtype(self):
        return np.uint8 if self.mode == "bytes" else np.float32


def flat_spec(space: sp.Space, mode: str = "f32") -> FlatSpec:
    assert mode in ("f32", "bytes")
    specs, offset = [], 0
    for path, leaf in sp.leaves(space):
        shape = sp.leaf_shape(leaf)
        dtype = sp.leaf_dtype(leaf)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        size = n * dtype.itemsize if mode == "bytes" else n
        specs.append(LeafSpec(path, shape, dtype, offset, size))
        offset += size
    return FlatSpec(space, mode, tuple(specs), offset)


@dataclass(frozen=True)
class ActionSpec:
    """Action tree ⇔ single flat action vector (paper §3.1).

    Discrete trees emulate to one MultiDiscrete (the paper's scheme);
    continuous (all-Box) trees emulate to one flat Box — the paper lists
    continuous actions as unsupported (§8); implemented here (beyond-paper).
    Mixed trees are not supported."""
    space: sp.Space
    kind: str            # "discrete" | "continuous"
    nvec: tuple
    cont_dim: int
    leaf_specs: tuple    # (path, leaf_shape, dtype, offset, size)

    @property
    def num_components(self) -> int:
        return len(self.nvec) if self.kind == "discrete" else self.cont_dim


def action_spec(space: sp.Space) -> ActionSpec:
    leaves_ = list(sp.leaves(space))
    boxes = [isinstance(l, sp.Box) for _, l in leaves_]
    if any(boxes):
        assert all(boxes), "mixed discrete/continuous action trees unsupported"
        specs, offset = [], 0
        for path, leaf in leaves_:
            shape = sp.leaf_shape(leaf)
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            specs.append(LeafSpec(path, shape, sp.leaf_dtype(leaf), offset, n))
            offset += n
        return ActionSpec(space, "continuous", (), offset, tuple(specs))
    nvec = sp.num_actions(space)
    specs, offset = [], 0
    for path, leaf in leaves_:
        if isinstance(leaf, sp.Discrete):
            size, shape = 1, ()
        else:  # MultiDiscrete
            size, shape = len(leaf.nvec), (len(leaf.nvec),)
        specs.append(LeafSpec(path, shape, sp.leaf_dtype(leaf), offset, size))
        offset += size
    return ActionSpec(space, "discrete", nvec, 0, tuple(specs))
