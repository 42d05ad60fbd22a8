"""A program's cost a device, counted from its torch ops: the counterpart
of ``repro/launch/hlo_analysis.py``.

The reference reads post-optimisation HLO text, because XLA's own
``cost_analysis`` counts a scanned layer once. The port runs eagerly and
has no HLO: ``analyze`` runs the program under a ``TorchDispatchMode`` and
counts every op it issues, every layer as it runs (there is no loop to
multiply out), on ``meta`` tensors in the dry run (``launch/dryrun.py``)
or on real ones:

  * FLOPs — every matrix product (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, convolutions) by ``torch.utils.flop_counter``'s
    formulas, plus each kernel call by its own work formula
    (``kernels/cost.py``). A kernel call is one unit, as the reference's
    ``KERNEL_`` scopes are: ``kernels/dispatch.py`` records its work and
    runs the backend ``opaque``, so the plain version's internals are
    never counted (the backward kernels record theirs on meta tensors);
  * bytes — each op's tensor operands plus its result (an in-place op's
    target counts as its result; an index update, ``index_copy_`` and the
    like, reads and writes its source's bytes only, the reference's
    dynamic-update-slice rule); views and allocations move nothing; a
    kernel call its formula's bytes; a collective twice its result;
  * collective bytes — by kind, from the plan's operators (each call's
    kind, group size and result bytes in the same ``cost.recording``),
    weighted by ``ring_factor`` of the group size (``hlo_analysis.py:228``).

It also tracks the bytes of live tensors the program makes (each op's
output, freed when its tensor is), and reports their peak above the
arguments: eager torch's peak, not XLA's temp size.

``parse``, ``input_output_aliases``, ``donated_params``, ``explain`` and
``trip_multipliers`` read XLA's text and have no counterpart here.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "broadcast")
# an index update reads and writes its source's region, not its target
_INDEX_UPDATES = {"index_copy_", "index_put_", "index_add_", "scatter_",
                  "masked_scatter_", "index_fill_"}
_ALLOCS = {"empty", "empty_like", "new_empty", "empty_strided",
           "new_empty_strided"}


def ring_factor(kind: str, g: int) -> float:
    """Bytes a rank moves over the links for each byte of the result of a
    collective over ``g`` ranks (a ring): the reference's ``ring_factor``
    by the port's kind names."""
    if g <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all_gather", "reduce_scatter"):
        return (g - 1) / g
    return 1.0      # broadcast: the root's bytes cross once


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if cost.is_opaque():
            return out
        name = func.overloadpacket.__name__
        schema = func._schema
        aliasing = bool(schema.returns) and \
            schema.returns[0].alias_info is not None
        if name in _ALLOCS or (aliasing and not schema.is_mutable):
            return out      # a view or an allocation moves nothing
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:     # takes tensors, reads shapes
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if name in _INDEX_UPDATES:
            src = [t for t in ins[1:] if t.is_floating_point()
                   or t.dtype == ins[0].dtype]
            self.bytes += 2 * sum(_nbytes(t) for t in src)
        else:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if not aliasing:
            for t in outs:
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count its cost on this rank. Returns
    {"flops", "bytes", "collective_bytes" (ring-weighted), "collectives"
    (ring-weighted bytes by kind), "collective_counts", "collective_raw"
    (result bytes by kind), "kernels" ({name: calls}), "kernel_flops",
    "kernel_bytes", "ops", "peak_bytes" (live above the arguments), "log"
    (the ``cost.Log`` of kernel calls and collectives), "result" (what
    ``fn`` returned)}."""
    count = _Count()
    with cost.recording() as log, count:
        result = fn(*args, **kwargs)
    kern, coll = log.kernels, log.collectives
    kflops = sum(f for _, f, _ in kern)
    kbytes = sum(b for _, _, b in kern)
    weighted = {k: 0.0 for k in KINDS}
    raw = {k: 0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    for kind, g, nbytes in coll:
        weighted[kind] += nbytes * ring_factor(kind, g)
        raw[kind] += nbytes
        counts[kind] += 1
    kernels: dict = {}
    for name, _, _ in kern:
        kernels[name] = kernels.get(name, 0) + 1
    return {"flops": count.flops + kflops,
            "bytes": count.bytes + kbytes + 2 * sum(raw.values()),
            "collective_bytes": sum(weighted.values()),
            "collectives": weighted, "collective_counts": counts,
            "collective_raw": raw, "kernels": kernels,
            "kernel_flops": kflops, "kernel_bytes": kbytes,
            "ops": count.ops, "peak_bytes": max(count.peak, 0),
            "log": log, "result": result}
