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


def init_params(spec_tree, generator: torch.Generator,
                param_dtype=torch.float32, device=None) -> dict:
    """Materialise a spec tree as a nested dict of tensors on ``device``
    (default: the generator's device), drawing leaves in tree order."""
    device = torch.device(device) if device is not None else generator.device
    out: dict = {}
    for path, spec in _leaves(spec_tree):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            x = torch.zeros(spec.shape, dtype=dtype, device=device)
        else:
            fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                                  else spec.shape[-1])
            x = (torch.randn(spec.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 / math.sqrt(fan)).to(dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
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


def quantize_params(params: dict, spec_tree, qdtype: str = "int8") -> dict:
    """Quantise a float tree drawn from ``spec_tree`` as the reference does
    (``repro/models/params.py::quantize_params``): symmetric per channel of
    the last dim, ``scale = max|w| / qmax + 1e-12`` over all other dims,
    ``round`` half to even, clipped to ±127 (int8) or ±7 (int4, then
    packed)."""
    qmax = QMAX[qdtype]
    out = {}
    for k, v in spec_tree.items():
        if not isinstance(v, ParamSpec):
            out[k] = quantize_params(params[k], v, qdtype)
            continue
        if not _quantizable(v):
            out[k] = params[k]
            continue
        w = params[k].float()
        s = w.abs().amax(dim=tuple(range(w.dim() - 1))) / qmax + 1e-12
        q = torch.clamp(torch.round(w / s), -qmax, qmax).to(torch.int8)
        out[k] = pack_int4(q) if qdtype == "int4" else q
        out[k + "_scale"] = s
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
