"""Meshes and the process group behind them.

The counterpart of ``repro/launch/mesh.py``. A JAX mesh names the axes of
the devices one process drives; in the port each rank is one process
(``torch.distributed``), so a mesh here is a small record over the default
process group: its axis names and sizes, with the ``shape`` mapping and
``axis_names`` a JAX ``Mesh`` has, which is all ``distributed/sharding.py``
reads. Its size must equal the world size, as ``jax.make_mesh`` must find
as many devices as the shape asks for.

  Single pod: (data=16, model=16) — 256 ranks.
  Multi-pod:  (pod=2, data=16, model=16) — 512 ranks.

``init_process_group`` gives a process that has none a group of its own
(world size 1): NCCL for a CUDA device, gloo for the CPU, over a loopback
``TCPStore``. A CUDA device never gets gloo. Every group the port makes
has a timeout (``COLLECTIVE_TIMEOUT_S``), so a collective whose peer died
raises in the survivors instead of hanging.

Functions, not module constants, so importing touches no device or group.
"""
from __future__ import annotations

import dataclasses
import datetime
import math

from repro_torch.configs.base import MeshConfig

# a collective that waits longer than this on a peer raises
COLLECTIVE_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over the default process group, rank-major in
    the order of the axes (the last axis varies fastest)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def world_size() -> int:
    """The default group's size, or 1 in a process that has none."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, axes) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    mesh = Mesh(axes, shape)
    n = world_size()
    if mesh.size != n:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {mesh.size} ranks; this "
            f"process group has {n} (launch {mesh.size} ranks, e.g. "
            f"launch.train --devices {mesh.size} on the CPU)")
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    cfg = mesh_config(multi_pod=multi_pod)
    return make_mesh(cfg.shape, cfg.axes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(shape=(2, 16, 16) if multi_pod else (16, 16),
                      axes=("pod", "data", "model") if multi_pod
                      else ("data", "model"))


def init_process_group(device, timeout_s: float = COLLECTIVE_TIMEOUT_S):
    """Make sure a default process group exists for ``device`` and return
    True when this call made it (its caller then destroys it). An
    existing group must be NCCL's for a CUDA device; with none, a group of
    one rank is made over a loopback store."""
    import torch
    import torch.distributed as dist
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if device.type == "cuda" and have != "nccl":
            raise RuntimeError(
                f"the process group runs {have}; the shard_map tier on "
                f"{device} needs nccl")
        return False
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=timeout)
    kw = {}
    if device.type == "cuda":
        # NCCL binds the group to one card: the current one unless named
        kw["device_id"] = device if device.index is not None else \
            torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(want, store=store, rank=0, world_size=1,
                            timeout=timeout, **kw)
    return True
