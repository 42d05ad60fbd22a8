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

The sharding helpers of the JAX package (``constrain``, ``use_weight``,
logical-axis rules) are not ported: on one device they are no-ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import last_len, pack_int4, unpack_int4


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"            # normal | zeros
    fan_in: Optional[int] = None    # for "normal": std = 1/sqrt(fan_in)
    dtype: Optional[torch.dtype] = None   # None => use param_dtype


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


def init_params(spec_tree, generator: torch.Generator,
                param_dtype=torch.float32, device=None,
                quantize: Optional[str] = None) -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``
    (default: the generator's device), drawing leaves in tree order. With
    ``quantize`` ("int8" or "int4") each quantisable leaf is quantised
    (``quantize_leaf``) before the next is drawn: the tree of
    ``quantize_params(init_params(spec_tree, ...), spec_tree, quantize)``,
    bit for bit, without the float tree."""
    device = torch.device(device) if device is not None else generator.device
    out: dict = {}
    for path, spec in _leaves(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        x = _draw(spec, generator, param_dtype, device)
        if quantize and _quantizable(spec):
            node[path[-1]], node[path[-1] + "_scale"] = quantize_leaf(
                x, quantize)
        else:
            node[path[-1]] = x
        del x      # a quantised leaf's float draw is freed before the next
    return out


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
            out[k] = ParamSpec(v.shape, v.init, v.fan_in, qd)
            out[k + "_scale"] = ParamSpec(v.shape[-1:], "ones",
                                          dtype=torch.float32)
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


def matmul(params, name: str, x, dtype, transposed: bool = False):
    """``x @ w`` at the use site of weight ``name``: the counterpart of
    ``repro/models/params.py::weight`` and the product after it.

    x is (..., K). The weight is viewed as (K, N): a (d, H, hd) weight as
    (d, H·hd), an (H, hd, d) one as (H·hd, d); with ``transposed`` it is an
    (N, K) table and the product ``x @ w.T`` (the tied unembed). Without
    ``<name>_scale`` this is ``x @ w.to(dtype)``. With it (a quantised tree)
    x's leading dims are flattened and the product goes through
    ``kernels.ops.quant_matmul``, which reads the int8 or packed int4 weight
    as it is stored."""
    w, scale = params[name], params.get(name + "_scale")
    K = x.shape[-1]
    if scale is None:
        w = w.to(dtype)
        return x @ (w.t() if transposed else w.reshape(K, -1))
    y = kops.quant_matmul(x.reshape(-1, K),
                          w if transposed else w.reshape(K, -1), scale,
                          transposed=transposed)
    return y.unflatten(0, x.shape[:-1])
