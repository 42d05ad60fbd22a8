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

The LM half — ``make_rules``, ``named``, ``train_state_pspecs``,
``lm_batch_pspecs`` and ``cache_pspecs``, the FSDP/TP plan behind ``--mesh
DxM`` for ``--arch`` — comes with the LM-sharding slice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_collectives():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


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
        COLLECTIVES["all_gather"] += 1
        out = torch.cat(parts)
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
    dist.all_reduce(buf, group=group)
    COLLECTIVES["all_reduce"] += 1
    buf /= dist.get_world_size(group)
    return _unflat(buf, tensors)


def allreduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    t = t.clone()
    dist.all_reduce(t, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def all_gather_stack(t: torch.Tensor, group=None) -> torch.Tensor:
    """(W, …): every rank's ``t`` in rank order, on every rank."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.stack(parts)


def broadcast_tree(tree, group=None, src: int = 0):
    """``tree`` as rank ``src`` holds it, on every rank (one broadcast of
    one flat buffer; the other ranks' values only give the shapes)."""
    leaves = tree_leaves(tree)
    buf = _flat(leaves)
    dist.broadcast(buf, src=src, group=group)
    COLLECTIVES["broadcast"] += 1
    return tree_unflatten(tree, _unflat(buf, leaves))
