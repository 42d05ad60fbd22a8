"""Parameter system: one spec tree gives the shapes, the init and the layout.

Modules declare nested dicts of ``ParamSpec``; ``init_params`` materialises
them as in ``repro/models/params.py``: ``normal / sqrt(fan_in)`` drawn in f32
and then cast, zeros, or ones, drawn from an explicit ``torch.Generator``.
``Params`` holds such a tree as an ``nn.Module`` whose parameter names follow
the spec's keys, so ``state_dict`` keys read ``layers.3.attn.wq``.

Quantised serving: ``quantize_spec`` / ``quantize_params`` turn every matmul
weight into int8 or int4 (packed two to a uint8, the layout of
``kernels/quant_matmul.py``) with a per-channel ``<name>_scale``; at its use
site ``matmul`` sends such a weight through ``kernels.ops.quant_matmul``.
``init_params(..., quantize=)`` draws and quantises leaf by leaf, so that a
model whose float tree does not fit on the card (jamba's 103 GB in bf16)
is built from its int8 tree and one leaf's draw; the result is bitwise
that of ``quantize_params`` on the whole float tree.

Layout: every spec names its logical axes (``axes``, the reference's
names), and ``make_pspec`` maps them to mesh axes by a rules table
(``DEFAULT_RULES``: ``embed`` over the data axes, FSDP/ZeRO-3;
``vocab``/``heads``/``kv_heads``/``mlp``/``expert``/``ssm_heads`` over
``model``, TP/EP). Under a plan (``distributed/plan.py``) each rank holds
its block of every leaf, and ``use_weight`` is the use site: the forward
all-gathers the weight over the data axes (and, where the rank's compute
columns are not its stored block, over ``model``), the backward
reduce-scatters the gradient back to the stored layout, as the
reference's custom VJP asks GSPMD to. With no plan ``use_weight`` and
``constrain`` return their input.

Quantised weights on a plan (serving): ``init_params(quantize=, plan=)``
quantises each global leaf as the unsharded init does (its scale over the
global leaf), then keeps this rank's blocks of the leaf and its scale, so
that a rank's blocks are blocks of the one-device quantised tree; at its
use ``use_quantized`` all-gathers the stored integers over the data axes
at their stored width (one byte an element, half a byte packed) and the
scale's matching part, and ``quant_matmul`` runs on the rank's block:
the reference's ``weight()``, whose gather moves the int8 value, never
bf16. A packed int4 leaf splits its last dim on whole bytes only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed import plan as _plan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import last_len, pack_int4, unpack_int4


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"            # normal | zeros
    fan_in: Optional[int] = None    # for "normal": std = 1/sqrt(fan_in)
    dtype: Optional[torch.dtype] = None   # None => use param_dtype
    axes: Optional[tuple] = None    # logical axis names, len == len(shape)

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not name the dims of "
                             f"shape {self.shape}")


# default logical -> mesh rules for the production mesh (data, model[, pod])
DEFAULT_RULES = {
    "embed": "data",        # FSDP / ZeRO-3
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "ssm_heads": "model",
    "layers": None,
    "periods": None,
    "null": None,
    # activation logical axes
    "batch": "data",
    "seq": None,
    "embed_act": None,
    "ctx": "data",          # context-parallel KV sequence dim (long_500k)
}

# the layout at a weight's use: tensor axes stay split, the FSDP axis is
# gathered
USE_RULES = {"vocab": "model", "heads": "model", "kv_heads": "model",
             "mlp": "model", "expert": "model", "ssm_heads": "model"}


class PartitionSpec(tuple):
    """One entry a dim: None, a mesh axis name, or a tuple of names (the
    parts of ``jax.sharding.PartitionSpec``, as a plain tuple)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def make_pspec(axes: tuple, rules: dict) -> PartitionSpec:
    """Logical axes -> PartitionSpec. A rule value is a mesh axis name or a
    tuple of names (FSDP over ("pod", "data")); each mesh axis is used at
    most once a leaf, the first logical axis winning."""
    used, parts = set(), []
    for a in axes:
        m = rules.get(a)
        if m is None:
            parts.append(None)
            continue
        if isinstance(m, (tuple, list)):
            avail = tuple(x for x in m if x not in used)
            if not avail:
                parts.append(None)
                continue
            used.update(avail)
            parts.append(avail if len(avail) > 1 else avail[0])
        elif m in used:
            parts.append(None)
        else:
            parts.append(m)
            used.add(m)
    return P(*parts)


def spec_axes(spec: ParamSpec) -> tuple:
    return spec.axes if spec.axes is not None else ("null",) * len(
        spec.shape)


def tree_map_specs(fn, spec_tree):
    return {k: tree_map_specs(fn, v) if not isinstance(v, ParamSpec)
            else fn(v) for k, v in spec_tree.items()}


def param_pspecs(spec_tree, rules: dict = None):
    rules = DEFAULT_RULES if rules is None else rules
    return tree_map_specs(lambda s: make_pspec(spec_axes(s), rules),
                          spec_tree)


def storage_pspec(axes: tuple, fsdp: tuple) -> PartitionSpec:
    """A leaf's stored layout with ``embed`` over the FSDP axes ``fsdp``
    (the reference's ``set_fsdp_axes``: here the plan carries them)."""
    return make_pspec(tuple(axes), dict(DEFAULT_RULES, embed=fsdp))


def use_weight(w, axes: tuple, model: Optional[str] = None):
    """A weight at its use site. ``w`` is this rank's stored block of a leaf
    with logical ``axes``. Under a plan the forward all-gathers it over the
    data axes (its FSDP dims) and the backward reduce-scatters the gradient
    to the stored layout (a sum over the data ranks). ``model`` also
    gathers its ``model`` dims, for a use whose columns are not the stored
    block: ``"sum"`` where each rank's gradient is a part (it computed some
    columns), ``"slice"`` where every rank computed the whole gradient (a
    replicated use, the router). No plan: ``w``."""
    pl = _plan.active()
    if pl is None:
        return w
    spec = storage_pspec(axes, pl.embed)
    for dim, part in enumerate(spec):
        if pl.part_of(part) == "data":
            w = _plan.gather(w, dim, "data")
    if model is not None:
        for dim, part in enumerate(spec):
            if part == "model":
                w = _plan.gather(w, dim, "model", model)
    return w


def use_quantized(w, scale, axes: tuple, model: bool = False):
    """A quantised weight ``w`` (int8, or int4 packed) and its ``scale``
    at their use under a plan, with no gradient (serving only): ``w``
    all-gathered over the data axes, and with ``model`` over ``model``
    too, at its stored width (``plan.gather_nograd``); the scale gathered
    where its split differs from the gathered weight's last dim (a scale
    over ``mlp`` split over ``model`` beside an expert weight whose
    ``model`` went to ``expert``) and cut to that dim's block (a ``scale``
    of None stays None). No plan: both as they are."""
    pl = _plan.active()
    if pl is None:
        return w, scale
    spec = storage_pspec(axes, pl.embed)
    for dim, part in enumerate(spec):
        kind = pl.part_of(part)
        if kind == "data" or (model and kind == "model"):
            w = _plan.gather_nograd(w, dim, kind)
    w = w.contiguous()      # the kernel reads rows of a contiguous last dim
    if scale is None:
        return w, None
    last = pl.part_of(spec[-1])
    last = last if last == "model" and not model else None
    kind = pl.part_of(storage_pspec(axes[-1:], pl.embed)[0])
    if kind != last:
        if kind is not None:
            scale = _plan.gather_nograd(scale, 0, kind)
        if last is not None:
            s0, n = _plan.tp_block(scale.shape[0])
            scale = scale[s0:s0 + n]
    return w, scale


def constrain(x, *logical_axes, rules: dict = None):
    """The reference's ``with_sharding_constraint`` by logical axes. A
    rank's activations already lie in the layout the plan gives them, so
    this is the identity, as the reference's is outside a mesh."""
    return x


def _leaves(spec_tree, prefix=()):
    for k, v in spec_tree.items():
        if isinstance(v, ParamSpec):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def _draw(spec: ParamSpec, generator, param_dtype, device):
    """One leaf: zeros, or normal / sqrt(fan_in) drawn in f32 (divided in
    place) and cast."""
    dtype = spec.dtype or param_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                          else spec.shape[-1])
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.div_(math.sqrt(fan)).to(dtype)


def _pspec_at(pspecs, path):
    for k in path:
        pspecs = pspecs[k]
    return pspecs


def init_params(spec_tree, generator: torch.Generator,
                param_dtype=torch.float32, device=None,
                quantize: Optional[str] = None, pspecs=None,
                plan=None) -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``
    (default: the generator's device), drawing leaves in tree order. With
    ``quantize`` ("int8" or "int4") each quantisable leaf is quantised
    (``quantize_leaf``) before the next is drawn: the tree of
    ``quantize_params(init_params(spec_tree, ...), spec_tree, quantize)``,
    bit for bit, without the float tree.

    With a ``plan`` (``distributed/plan.py``) and the tree's ``pspecs``
    each leaf is this rank's block of the global one: a zeros leaf is made
    at its block's shape; a drawn leaf is drawn whole (every rank draws
    the same stream), quantised whole where ``quantize`` says, sliced and
    freed before the next, so that no more than one global leaf is ever
    held. A packed int4 leaf whose last dim is split must split it on
    whole bytes: an odd part raises, naming the leaf and the mesh."""
    device = torch.device(device) if device is not None else generator.device
    if device.type == "meta":
        return _meta_tree(spec_tree, param_dtype, quantize, pspecs, plan)
    out: dict = {}
    for path, spec in _leaves(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if plan is not None:
            ps = _pspec_at(pspecs, path)
            if spec.init == "zeros":
                node[path[-1]] = torch.zeros(
                    plan.local_shape(spec.shape, ps),
                    dtype=spec.dtype or param_dtype, device=device)
                continue
            x = _draw(spec, generator, param_dtype, device)
            if quantize and _quantizable(spec):
                if quantize == "int4":
                    _whole_bytes(".".join(path), spec.shape, ps, plan)
                q, sc = quantize_leaf(x, quantize)
                del x
                node[path[-1]] = _plan.shard(q, ps, plan)
                node[path[-1] + "_scale"] = _plan.shard(
                    sc, _pspec_at(pspecs, path[:-1] + (path[-1] + "_scale",)),
                    plan)
                del q
            else:
                node[path[-1]] = _plan.shard(x, ps, plan)
                del x
            continue
        x = _draw(spec, generator, param_dtype, device)
        if quantize and _quantizable(spec):
            node[path[-1]], node[path[-1] + "_scale"] = quantize_leaf(
                x, quantize)
        else:
            node[path[-1]] = x
        del x      # a quantised leaf's float draw is freed before the next
    return out


def _meta_tree(spec_tree, param_dtype, quantize, pspecs, plan) -> dict:
    """The tree ``init_params`` makes, as empty ``meta`` tensors of each
    leaf's (block's) shape and dtype: nothing allocated, nothing drawn (the
    dry run's, ``launch/dryrun.py``). A packed int4 leaf holds its last dim
    two to a byte."""
    out: dict = {}
    spec_tree = quantize_spec(spec_tree, quantize) if quantize else spec_tree
    for path, spec in _leaves(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        shape = spec.shape
        if spec.dtype == torch.uint8:
            _whole_bytes(".".join(path), shape, _pspec_at(pspecs, path)
                         if plan is not None else (), plan)
            shape = shape[:-1] + ((shape[-1] + 1) // 2,)
        if plan is not None:
            shape = plan.local_shape(shape, _pspec_at(pspecs, path))
        node[path[-1]] = torch.empty(shape, dtype=spec.dtype or param_dtype,
                                     device="meta")
    return out


def _whole_bytes(name: str, shape, pspec, plan) -> None:
    """A packed int4 leaf's last dim, split over k ranks, must give each an
    even part: two elements a byte, a byte never shared."""
    if plan is None:
        return
    kind = plan.part_of(tuple(pspec)[len(shape) - 1]
                        if len(pspec) >= len(shape) else None)
    if kind is None:
        return
    k = plan.size_of(kind)
    if shape[-1] % k or (shape[-1] // k) % 2:
        raise ValueError(
            f"int4 leaf {name} of shape {tuple(shape)}: its last dim split "
            f"over the {k} ranks of {tuple(pspec)[-1]!r} on mesh "
            f"{plan.mesh.shape} gives parts of {shape[-1] / k:g} elements; "
            f"packed two to a byte, a part must be even")


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(spec_tree))


class Params(nn.Module):
    """A nested dict of tensors as a module tree: ``p["wq"]`` reads a
    parameter, ``p["attn"]`` a sub-tree, as the JAX code reads its dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key, default=None):
        return self[key] if key in self else default


# -- quantised weights ---------------------------------------------------------

QMAX = {"int8": 127.0, "int4": 7.0}


def _quantizable(spec: ParamSpec) -> bool:
    return len(spec.shape) >= 2 and spec.init == "normal" \
        and spec.dtype is None


def quantize_spec(spec_tree, qdtype: str = "int8"):
    """The spec tree of int8 / int4 serving (``repro/models/params.py::
    quantize_spec``): every >= 2-D ``normal`` leaf with no fixed dtype
    becomes int8 (int4: uint8, packed; the shape stays the logical one) and
    gains a f32 ``<name>_scale`` over its last dim. The port has no stacked
    layer axis, so the scale is (last,)."""
    qd = torch.uint8 if qdtype == "int4" else torch.int8
    out = {}
    for k, v in spec_tree.items():
        if not isinstance(v, ParamSpec):
            out[k] = quantize_spec(v, qdtype)
        elif _quantizable(v):
            out[k] = ParamSpec(v.shape, v.init, v.fan_in, qd, v.axes)
            out[k + "_scale"] = ParamSpec(
                v.shape[-1:], "ones", dtype=torch.float32,
                axes=None if v.axes is None else v.axes[-1:])
        else:
            out[k] = v
    return out


QUANT_ROWS = 1 << 24    # elements of a leaf quantised at once


def quantize_leaf(w, qdtype: str = "int8"):
    """(q, scale) of one float leaf, as the reference quantises it
    (``repro/models/params.py::quantize_params``): symmetric per channel of
    the last dim, ``scale = max|w| / qmax + 1e-12`` over all other dims (for
    a stacked (E, d, n) expert leaf one (n,) scale, shared across E and d),
    ``round`` half to even, clipped to ±127 (int8) or ±7 (int4, then
    packed). The leaf is read as (rows, n) in slices of about
    ``QUANT_ROWS`` elements, its f32 copies one slice at a time: the scale
    is the max of the slices' maxima, and every later step is elementwise,
    so the result is exact."""
    qmax, n = QMAX[qdtype], w.shape[-1]
    rows = w.reshape(-1, n)
    step = max(1, QUANT_ROWS // n)
    amax = None
    for r in range(0, rows.shape[0], step):
        m = rows[r:r + step].float().abs().amax(dim=0)
        amax = m if amax is None else torch.maximum(amax, m)
    s = amax / qmax + 1e-12
    q = torch.empty((rows.shape[0], (n + 1) // 2 if qdtype == "int4" else n),
                    dtype=torch.uint8 if qdtype == "int4" else torch.int8,
                    device=w.device)
    for r in range(0, rows.shape[0], step):
        qr = torch.clamp(torch.round(rows[r:r + step].float() / s), -qmax,
                         qmax).to(torch.int8)
        q[r:r + step] = pack_int4(qr) if qdtype == "int4" else qr
    return q.view(w.shape[:-1] + q.shape[-1:]), s


def quantize_params(params: dict, spec_tree, qdtype: str = "int8") -> dict:
    """Quantise a float tree drawn from ``spec_tree``: every quantisable
    leaf by ``quantize_leaf``, the others as they are."""
    out = {}
    for k, v in spec_tree.items():
        if not isinstance(v, ParamSpec):
            out[k] = quantize_params(params[k], v, qdtype)
        elif _quantizable(v):
            out[k], out[k + "_scale"] = quantize_leaf(params[k], qdtype)
        else:
            out[k] = params[k]
    return out


def stored(w, scale=None):
    """A weight's values as stored, without its scale: a packed int4 leaf
    (uint8, with its ``scale``) unpacked to int8, anything else as it is.
    The reference reads some quantised leaves so (``value``, ``conv_w``)."""
    if scale is not None and w.dtype == torch.uint8:
        return unpack_int4(w, last_len(w, scale))
    return w


def no_grad(name: str, x) -> None:
    """Quantised weights on a plan serve only: their gather has no
    backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name}: quantised weights on a mesh serve only (their stored "
            f"gather has no backward); train the float tree")


def matmul(params, name: str, x, dtype, transposed: bool = False,
           axes: tuple = ()):
    """``x @ w`` at the use site of weight ``name``: the counterpart of
    ``repro/models/params.py::weight`` and the product after it.

    x is (..., K). The weight is viewed as (K, N): a (d, H, hd) weight as
    (d, H·hd), an (H, hd, d) one as (H·hd, d); with ``transposed`` it is an
    (N, K) table and the product ``x @ w.T`` (the tied unembed). Without
    ``<name>_scale`` this is ``x @ w.to(dtype)``. With it (a quantised tree)
    x's leading dims are flattened and the product goes through
    ``kernels.ops.quant_matmul``, which reads the int8 or packed int4 weight
    as it is stored. ``axes`` are the weight's logical axes: under a plan
    it is read through ``use_weight`` (its FSDP gather), so that x and the
    product are this rank's columns or rows of the reference's."""
    w, scale = params[name], params.get(name + "_scale")
    K = x.shape[-1]
    if _plan.active() is not None:
        if scale is None:
            w = use_weight(w, axes)
        else:
            no_grad(name, x)
            w, scale = use_quantized(w, scale, axes)
    if scale is None:
        w = w.to(dtype)
        return x @ (w.t() if transposed else w.reshape(K, -1))
    return qmm(x, w if transposed else w.reshape(K, -1), scale, transposed)


def qmm(x, w, scale, transposed: bool = False):
    """x (..., K) through ``kernels.ops.quant_matmul`` with the 2-D
    quantised weight ``w`` as it lies on this rank: the leading dims
    flattened and restored."""
    y = kops.quant_matmul(x.reshape(-1, x.shape[-1]), w, scale,
                          transposed=transposed)
    return y.unflatten(0, x.shape[:-1])
