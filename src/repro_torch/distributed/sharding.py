"""Sharding: how Ocean PPO is laid out over the ranks of a data-parallel
run.

The counterpart of ``repro/distributed/sharding.py``, its Ocean half (the
TrainEngine's ``shard_map`` tier). One rank per process — PyTorch's SPMD
idiom for what ``shard_map`` does within one:

  * the env batch is split into S contiguous blocks, S the mesh's
    data-parallel size (``dp_size``): rank s steps envs
    [s·N/S, (s+1)·N/S). Every leaf of the rollout carry (env state, obs,
    policy carry, done mask) is env-major, so rank s's carry is ``block(
    carry, S, s)`` of the global one, and ``gather_blocks`` rebuilds the
    global layout (a checkpoint holds it, so it restores on any S);
  * params and optimizer moments are replicated: rank 0's are broadcast
    (``broadcast_tree``), and every minibatch's gradients, loss and stats
    are averaged by one all-reduce over one flat buffer
    (``allreduce_mean``) before the identical AdamW step on every rank.

``COLLECTIVES`` counts the collectives issued, by kind.

The LM half, the FSDP/TP plan behind ``--mesh DxM`` for ``--arch``: one
rules table (``make_rules``) drives every layout, as in the reference:

  embed (d_model)            → FSDP over ("pod", "data")  [ZeRO-3]
  vocab/heads/kv_heads/mlp/expert/ssm_heads → "model"     [TP / EP]
  batch                      → ("pod", "data")            [DP]
  ctx (long-context KV seq)  → ("pod", "data")            [CP]

``train_state_pspecs``, ``lm_batch_pspecs`` and ``cache_pspecs`` give the
``PartitionSpec`` trees (the port's caches are per layer, so a cache
spec has no leading ``periods`` entry); ``named`` pairs each with the
mesh as a ``NamedSharding``, the record of which global slice each rank
holds (``checkpoint/ckpt.py`` reads it to write and restore shards);
``abstract_train_state`` and ``abstract_caches`` are the shapes and
dtypes on the ``meta`` device. The run-time side (each rank's blocks, the
collectives at each use) is ``distributed/plan.py``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import cost

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
               "reduce_scatter": 0}


def reset_collectives():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class VirtualGroup:
    """``size`` ranks with no process behind them: the groups of a virtual
    plan (``distributed/plan.py::Plan.virtual``, the dry run's). A
    collective over one records itself as a real one does and returns an
    output of the right shape, its values undefined (the dry run's tensors
    are on the ``meta`` device)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __repr__(self):
        return f"VirtualGroup({self.size})"


def group_size(group=None) -> int:
    if isinstance(group, VirtualGroup):
        return group.size
    return dist.get_world_size(group)


def record(kind: str, result: torch.Tensor, group=None) -> None:
    """Count one collective of ``kind`` whose result is ``result``, and add
    it (kind, group size, result bytes) to every open
    ``kernels/cost.py::recording``."""
    COLLECTIVES[kind] += 1
    cost.record_collective(kind, group_size(group),
                           result.numel() * result.element_size())


# -- Ocean data-parallel (TrainEngine shard_map tier) -------------------------

def data_axes(mesh) -> tuple:
    """The mesh axes Ocean PPO data-parallelizes over (envs + batch)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


# -- carries: env-major trees of tensors --------------------------------------

def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested dicts, tuples and
    NamedTuples; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [tree_map(fn, c) for c in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def block(tree, S: int, s: int):
    """Block ``s`` of ``S`` along every leaf's leading (env) axis."""
    def one(x):
        n = x.shape[0] // S
        return x[s * n:(s + 1) * n]
    return tree_map(one, tree)


def cat_blocks(trees):
    """The blocks of ``trees`` (one per block, in order) joined along every
    leaf's leading axis."""
    leaves = [tree_leaves(t) for t in trees]
    return tree_unflatten(trees[0], [torch.cat(xs) for xs in zip(*leaves)])


def gather_blocks(tree, group=None):
    """Every rank's block of ``tree`` joined in rank order: the global
    layout, on every rank. Collective."""
    W = dist.get_world_size(group)

    def one(x):
        x = x.contiguous()
        v = x.view(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(v) for _ in range(W)]
        dist.all_gather(parts, v, group=group)
        out = torch.cat(parts)
        record("all_gather", out, group)
        return out.view(torch.bool) if x.dtype == torch.bool else out
    return tree_map(one, tree)


# -- replicated state ---------------------------------------------------------

def _flat(tensors):
    for t in tensors:
        if not t.is_floating_point() or t.element_size() > 4:
            raise TypeError(f"a flat f32 buffer holds f32/bf16/f16 leaves, "
                            f"not {t.dtype}")
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _unflat(buf, like):
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(buf[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def allreduce_mean(tensors, group=None) -> list:
    """The mean over the ranks of each tensor, by one all-reduce of one
    flat f32 buffer (a sum, then a division by the world size: gloo has no
    average, and at world size 1 both steps are exact)."""
    buf = _flat(tensors)
    if not isinstance(group, VirtualGroup):
        dist.all_reduce(buf, group=group)
    record("all_reduce", buf, group)
    buf /= group_size(group)
    return _unflat(buf, tensors)


def allreduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    t = t.clone()
    if not isinstance(group, VirtualGroup):
        dist.all_reduce(t, group=group)
    record("all_reduce", t, group)
    return t


def all_gather_stack(t: torch.Tensor, group=None) -> torch.Tensor:
    """(W, …): every rank's ``t`` in rank order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    if not isinstance(group, VirtualGroup):
        dist.all_gather(parts, t.contiguous(), group=group)
    out = torch.stack(parts)
    record("all_gather", out, group)
    return out


def broadcast_tree(tree, group=None, src: int = 0):
    """``tree`` as rank ``src`` holds it, on every rank (one broadcast of
    one flat buffer; the other ranks' values only give the shapes)."""
    leaves = tree_leaves(tree)
    buf = _flat(leaves)
    dist.broadcast(buf, src=src, group=group)
    record("broadcast", buf, group)
    return tree_unflatten(tree, _unflat(buf, leaves))


# -- the LM plan: rules and layouts -------------------------------------------

def make_rules(mesh) -> dict:
    from repro_torch.models.params import DEFAULT_RULES
    fsdp = data_axes(mesh)
    fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    rules = dict(DEFAULT_RULES)
    rules.update({"embed": fsdp, "batch": fsdp, "ctx": fsdp})
    return rules


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh: the global slice rank r holds."""
    mesh: object
    spec: tuple

    def index(self, shape, rank: int = None) -> tuple:
        from repro_torch.distributed.plan import Plan
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        return Plan(self.mesh, rank=rank, groups={}).block(shape, self.spec)

    def writes(self, rank: int = None) -> bool:
        """Whether ``rank`` is the first of the ranks that hold its block
        (its index 0 along every axis the spec leaves whole), the one that
        writes it to a checkpoint."""
        from repro_torch.distributed.plan import coords
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        used = set()
        for part in self.spec:
            if part is not None:
                used.update(part if isinstance(part, tuple) else (part,))
        c = coords(self.mesh, rank)
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in used)


def named(mesh, pspec_tree):
    """``NamedSharding(mesh, p)`` for every ``PartitionSpec`` p of the
    tree."""
    from repro_torch.models.params import PartitionSpec
    if isinstance(pspec_tree, PartitionSpec):
        return NamedSharding(mesh, pspec_tree)
    if isinstance(pspec_tree, dict):
        return {k: named(mesh, v) for k, v in pspec_tree.items()}
    if isinstance(pspec_tree, (list, tuple)):
        kids = [named(mesh, c) for c in pspec_tree]
        return type(pspec_tree)(*kids) if hasattr(pspec_tree, "_fields") \
            else type(pspec_tree)(kids)
    return pspec_tree


def train_state_pspecs(policy, rules: dict):
    from repro_torch.models.params import P
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.rl.learner import TrainState
    pp = policy.pspecs(rules)
    return TrainState(params=pp, opt=AdamWState(step=P(), m=pp, v=pp),
                      step=P())


def abstract_train_state(policy, opt_dtype):
    """The global train state's shapes and dtypes, as tensors on the
    ``meta`` device (nothing allocated)."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.params import tree_map_specs
    from repro_torch.optim.adamw import AdamWState, tree_map
    from repro_torch.rl.learner import TrainState
    pdt = dtype_of(policy.cfg.param_dtype)
    params = tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype or pdt, device="meta"),
        policy.spec())
    odt = dtype_of(opt_dtype) if isinstance(opt_dtype, str) else opt_dtype
    zeros = lambda p: torch.empty(p.shape, dtype=odt, device="meta")
    step = lambda: torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=params,
                      opt=AdamWState(step=step(), m=tree_map(zeros, params),
                                     v=tree_map(zeros, params)),
                      step=step())


def lm_batch_pspecs(cfg, rules: dict) -> dict:
    from repro_torch.models.params import P
    from repro_torch.rl.learner import lm_batch_fields
    b = rules["batch"]
    T = 1 + (cfg.frontend_prefix if cfg.frontend else 0)
    return {k: P(*([b] + [None] * (len(shape) - 1)))
            for k, (shape, _) in lm_batch_fields(cfg, 1, T).items()}


def cache_pspecs(cfg, rules: dict, context_parallel: bool = False):
    """PartitionSpec tree of ``transformer.Caches``: the reference's, one
    entry a layer (no ``periods`` dim). decode_32k shards the batch over
    the data axes; long_500k (``context_parallel``, B = 1) the KV sequence
    dim instead."""
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import P
    b, c = rules["batch"], rules["ctx"]
    kv, ssm = [], []
    for i in range(cfg.num_layers):
        mixer, _ = tr.layer_kinds(cfg, i)
        if mixer == "attn":
            spec = P(None, c, "model", None) if context_parallel else \
                P(b, None, "model", None)
            kv.append(attn.KVCache(k=spec, v=spec, length=P()))
            ssm.append(None)
        else:
            bb = None if context_parallel else b
            kv.append(None)
            ssm.append(ssm_mod.SSMCache(conv=P(bb, None, "model"),
                                        state=P(bb, "model", None, None)))
    return tr.Caches(kv=kv, ssm=ssm, length=P())


def abstract_caches(cfg, tp: int, batch: int, max_len: int):
    """The caches' shapes and dtypes (``meta`` tensors)."""
    from repro_torch.models import transformer as tr
    return tr.init_caches(cfg, batch, max_len, device="meta", tp=tp)
