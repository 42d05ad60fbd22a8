"""The LM plan at run time: which slice of each global leaf a rank holds,
and the collectives that move between the layouts.

The reference jits one program over a mesh and lets GSPMD insert the
collectives that its sharding constraints imply. The port runs one rank
per process (``torch.distributed``), each holding its own shard, and
writes those collectives out:

  * ``Plan`` is one rank's view of a mesh (``launch/mesh.py::Mesh``): its
    coordinates, the data-parallel size D (the product of the FSDP axes,
    ``("data",)`` or ``("pod", "data")``), the tensor-parallel size M (the
    ``model`` axis), and two process groups: the ranks that share this
    rank's ``model`` coordinate (``data``, over which FSDP gathers and
    the batch splits) and those that share its data coordinates
    (``model``, over which TP reduces);
  * a pspec (``models/params.py::PartitionSpec``) gives each dim of a leaf
    None, ``"model"`` or the FSDP part; ``block`` is the slice of the
    global leaf rank r holds: along a split dim the (index over its
    axes)-th of n equal blocks, the first axis major, as JAX lays out a
    ``NamedSharding``. A dim that its axes do not divide raises, as a jit
    with such ``in_shardings`` does;
  * the autograd operators, each with its backward stated:

      ``gather(x, dim, group, bwd)``   all-gather along ``dim``; backward
          a reduce-scatter (``bwd="sum"``: each rank's gradient is a part)
          or this rank's block of it (``"slice"``: every rank computed the
          whole gradient, identical bit for bit);
      ``enter(x)``     identity; backward an all-reduce over ``model`` (the
          input of a column-parallel region, Megatron's f);
      ``leave(x)``     an all-reduce over ``model``; backward identity (the
          output of a row-parallel region, Megatron's g);
      ``reduce(x)``    an all-reduce over ``model`` both ways (a sum whose
          result feeds each rank's part, as the gated norm's variance);
      ``data_mean(x)`` the mean over ``data``; backward identity (a
          statistic of the global batch in a loss every data rank holds
          whole, as the MoE aux loss's);

  * and, for serving (no gradient): ``gather_nograd`` all-gathers a
    tensor as it lies: a quantised weight at its stored width (int8, or
    int4 packed two to a byte), as the reference's ``weight()`` pins its
    FSDP gather on the integer value, or an SSM layer's conv window;
    ``merge_decode`` is the context-parallel decode's merge over
    ``data``: each rank attended over its slice of the KV sequence
    and holds (out, lse) a row, in f32; one all-reduce of the max lse, then
    one of the rescaled numerators and denominators (flash-decode's
    two-pass trick, which the reference leaves to GSPMD); rounded once to
    the cache's type after it, as the reference's is. At world size 1 it
    is out · 1.0 / 1.0, bit for bit the unsharded decode.

With no plan in scope (``active()`` is None) the model code calls none of
them: one device, the layout of earlier slices, bit for bit. Over a group
of one rank a collective is counted and returns its input, with no call
and no copy (every group of a plan of world size 1, the ``data`` groups
of a ``1xM`` mesh, the ``model`` groups of a ``Dx1`` one), so a plan of
world size 1 steps as the unsharded model does, bit for bit.

``COLLECTIVES`` (``distributed/sharding.py``) counts each call by kind;
an open ``kernels/cost.py::recording`` also logs its group size and
result bytes. ``Plan.virtual`` is rank 0's view of a mesh with no process
group (the dry run's, ``launch/dryrun.py``):
its groups are ``sharding.VirtualGroup``s, over which every collective
records itself and returns an output of the right shape.
Gloo has no reduce-scatter for every dtype across versions: on gloo it is
an all-reduce and a slice (counted as the reduce-scatter it stands for).
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (VirtualGroup, data_axes,
                                              group_size, record)

_PLAN: Optional["Plan"] = None


def active() -> Optional["Plan"]:
    """The plan in scope, or None (one device)."""
    return _PLAN


@contextlib.contextmanager
def scope(plan: Optional["Plan"]):
    """Run the block under ``plan`` (None: no plan). A module global, not a
    thread-local: autograd runs a CUDA backward, and so a checkpoint's
    recomputation, on a thread of its own."""
    global _PLAN
    saved, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        _PLAN = saved


def coords(mesh, rank: int) -> dict:
    """Rank-major coordinates, the last axis fastest."""
    out = {}
    for a, n in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[a] = rank % n
        rank //= n
    return {a: out[a] for a in mesh.axis_names}


def _index(c: dict, axes, sizes: dict) -> int:
    """The combined index over ``axes``, the first axis major."""
    i = 0
    for a in axes:
        i = i * sizes[a] + c[a]
    return i


class Plan:
    """One rank's view of ``mesh``. Collective to build (``new_group`` for
    every coset, on every rank, in one order) unless ``groups`` is given:
    ``{"data": group, "model": group[, "world": group]}``, as a test on one
    rank passes. ``embed`` is the axes the stored ``embed`` dims are split
    over: the FSDP axes (``with_embed`` gives the plan where the rules
    replicate them, int4 serving, ``models/policy.py``)."""

    def __init__(self, mesh, rank: Optional[int] = None, groups=None):
        self.mesh = mesh
        self.sizes = dict(zip(mesh.axis_names, mesh.sizes))
        self.fsdp = data_axes(mesh)
        self.embed = self.fsdp
        self.rank = dist.get_rank() if rank is None else rank
        self.coord = coords(mesh, self.rank)
        self.dp = math.prod(self.sizes[a] for a in self.fsdp)
        self.tp = self.sizes.get("model", 1)
        self.dp_index = _index(self.coord, self.fsdp, self.sizes)
        self.tp_index = self.coord.get("model", 0)
        self.groups = groups if groups is not None else self._make_groups()

    @classmethod
    def virtual(cls, mesh):
        """Rank 0's view of ``mesh`` with no process group: its groups are
        ``VirtualGroup``s of the data, model and world sizes."""
        pl = cls(mesh, rank=0, groups={})
        pl.groups = {"data": VirtualGroup(pl.dp),
                     "model": VirtualGroup(pl.tp),
                     "world": VirtualGroup(mesh.size)}
        return pl

    def with_embed(self, embed: tuple) -> "Plan":
        """This plan, its groups shared, with the stored ``embed`` dims
        split over ``embed``."""
        pl = copy.copy(self)
        pl.embed = tuple(embed)
        return pl

    def _make_groups(self):
        from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S
        kw = {"timeout": datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)}
        world = self.mesh.size
        every = [coords(self.mesh, r) for r in range(world)]
        out = {}
        for name, keep in (("data", ("model",)),
                           ("model", self.fsdp)):
            cosets: dict = {}
            for r, c in enumerate(every):
                cosets.setdefault(tuple(c.get(a, 0) for a in keep),
                                  []).append(r)
            mine = tuple(self.coord.get(a, 0) for a in keep)
            for key, ranks in sorted(cosets.items()):
                g = dist.group.WORLD if len(ranks) == world else \
                    dist.new_group(ranks, **kw)
                if key == mine:
                    out[name] = g
        out["world"] = dist.group.WORLD
        return out

    # -- layout --------------------------------------------------------------
    def part_of(self, part) -> Optional[str]:
        """"data" or "model" for a pspec part, None for a replicated dim."""
        if part is None:
            return None
        if part == "model":
            return "model"
        axes = part if isinstance(part, tuple) else (part,)
        if set(axes) - set(self.fsdp):
            raise ValueError(f"pspec part {part!r} is not the FSDP axes "
                             f"{self.fsdp} or 'model'")
        return "data"

    def size_of(self, kind: str) -> int:
        return self.dp if kind == "data" else self.tp

    def index_of(self, kind: str) -> int:
        return self.dp_index if kind == "data" else self.tp_index

    def block(self, shape, pspec) -> tuple:
        """This rank's slice of a global leaf of ``shape``."""
        out = []
        for n, part in zip(shape, tuple(pspec) + (None,) * len(shape)):
            kind = self.part_of(part)
            if kind is None:
                out.append(slice(None))
                continue
            k = self.size_of(kind)
            if n % k:
                raise ValueError(f"dim {n} of a leaf of shape "
                                 f"{tuple(shape)} is not divisible by the "
                                 f"{k} ranks of {part!r} ({pspec})")
            i = self.index_of(kind)
            out.append(slice(i * n // k, (i + 1) * n // k))
        return tuple(out)

    def local_shape(self, shape, pspec) -> tuple:
        return tuple(len(range(*s.indices(n)))
                     for s, n in zip(self.block(shape, pspec), shape))

    def replicated_over(self, pspec) -> tuple:
        """The kinds ("data", "model") that ``pspec`` does not split."""
        kinds = {self.part_of(p) for p in pspec}
        return tuple(k for k in ("data", "model") if k not in kinds)


# -- raw collectives (counted) -------------------------------------------------

# Over a group of one rank each is counted and returns its input: no call,
# no copy, the bits unchanged.

def _all_gather(x, dim: int, group):
    n = group_size(group)
    if n == 1:
        record("all_gather", x, group)
        return x
    x = x.movedim(dim, 0).contiguous()
    if isinstance(group, VirtualGroup):
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    record("all_gather", out, group)
    return out.movedim(0, dim)


def _reduce_scatter(g, dim: int, group):
    n = group_size(group)
    if n == 1:
        record("reduce_scatter", g, group)
        return g
    g = g.movedim(dim, 0).contiguous()
    if isinstance(group, VirtualGroup):
        out = g.chunk(n)[0].clone()
    elif dist.get_backend(group) == "gloo":
        g = g.clone()       # at dim 0 ``g`` is the incoming gradient itself
        dist.all_reduce(g, group=group)
        out = g.chunk(n)[_group_index(group)]
    else:
        out = torch.empty_like(g.chunk(n)[0])
        dist.reduce_scatter(out, list(g.chunk(n)), group=group)
    record("reduce_scatter", out, group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    if group_size(group) == 1:
        record("all_reduce", x, group)
        return x
    x = x.clone()
    if not isinstance(group, VirtualGroup):
        dist.all_reduce(x, op=op, group=group)
    record("all_reduce", x, group)
    return x


def _group_index(group) -> int:
    if isinstance(group, VirtualGroup):
        return 0
    if group is dist.group.WORLD:
        return dist.get_rank()
    return dist.get_group_rank(group, dist.get_rank())


# -- autograd operators --------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, bwd):
        ctx.dim, ctx.group, ctx.bwd = dim, group, bwd
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "sum":
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        n = group_size(ctx.group)
        part = g.chunk(n, dim=ctx.dim)[_group_index(ctx.group)]
        return part.contiguous(), None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x, dim: int, kind: str, bwd: str = "sum"):
    """All-gather ``x`` along ``dim`` over the plan's ``kind`` group."""
    return _Gather.apply(x, dim, _PLAN.groups[kind], bwd)


def enter(x):
    """Identity, all-reduce of the gradient over ``model``; no plan: x."""
    return x if _PLAN is None else _Enter.apply(x, _PLAN.groups["model"])


def leave(x):
    """All-reduce over ``model``, identity backward; no plan: x."""
    return x if _PLAN is None else _Leave.apply(x, _PLAN.groups["model"])


def reduce(x):
    """All-reduce over ``model`` both ways; no plan: x."""
    return x if _PLAN is None else _Reduce.apply(x, _PLAN.groups["model"])


def reduce_max(x):
    """The max over ``model``, without a gradient; no plan: x."""
    if _PLAN is None:
        return x
    return _all_reduce(x.detach(), _PLAN.groups["model"], dist.ReduceOp.MAX)


def data_mean(x):
    """The mean over ``data``, identity backward; no plan: x."""
    if _PLAN is None:
        return x
    return _DataMean.apply(x, _PLAN.groups["data"], _PLAN.dp)


def gather_nograd(w, dim: int, kind: str):
    """All-gather ``w`` along ``dim`` over the plan's ``kind`` group as it
    lies (a quantised weight at one byte an element, or half a byte
    packed), with no gradient: the serving path's gather."""
    return _all_gather(w, dim % w.dim(), _PLAN.groups[kind])


def merge_decode(out, lse):
    """The context-parallel decode's merge over ``data``: ``out`` (B, H,
    hd) and ``lse`` (B, H), both f32, are this rank's attention over its
    slice of the KV sequence (``lse`` -inf where the slice holds no filled
    position, ``out`` 0 there). One all-reduce takes the max lse M, one
    more sums exp(lse - M) · out and exp(lse - M) together; their ratio is
    the attention over the whole sequence, in f32 (the caller rounds it
    once). No plan: ``out``."""
    if _PLAN is None:
        return out
    group = _PLAN.groups["data"]
    m = _all_reduce(lse, group, dist.ReduceOp.MAX)
    w = torch.exp(lse - m)[..., None]                       # (B, H, 1)
    buf = _all_reduce(torch.cat([out * w, w], dim=-1), group)
    return buf[..., :-1] / buf[..., -1:]


def tp_block(n: int):
    """(start, size) of this rank's block of ``n`` along ``model`` (the
    whole of it with no plan)."""
    if _PLAN is None:
        return 0, n
    k = n // _PLAN.tp
    return _PLAN.tp_index * k, k


# -- whole leaves (no autograd) ------------------------------------------------

def shard(x, pspec, plan: Plan):
    """This rank's block of the global leaf ``x``, as its own tensor."""
    return x[plan.block(x.shape, pspec)].clone()


def unshard(x, pspec, plan: Plan):
    """The global leaf from every rank's block ``x``. Collective."""
    for dim, part in enumerate(pspec):
        kind = plan.part_of(part)
        if kind is not None:
            x = _all_gather(x, dim, plan.groups[kind])
    return x
