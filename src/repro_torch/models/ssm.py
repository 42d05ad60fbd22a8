"""Mamba2 block (SSD), the counterpart of ``repro/models/ssm.py``.

Block structure (Mamba2 paper): in_proj → [z | x | B | C | dt], short causal
conv over (x, B, C), SiLU, SSD scan, gated RMSNorm (y·silu(z)), out_proj.
The recurrent state (B, H, hd, ds) and the conv window are the policy's
recurrent cell for the serve step.

Numerics follow the reference step for step: the conv is the explicit sum
of shifted products in ``cfg.dtype`` (not ``conv1d``), ``dt`` and the decay
in f32, ``D`` rounded to ``cfg.dtype`` before ``y + D·x``. The scan goes
through ``kernels.ops.ssd``: the CUDA kernel for CUDA tensors. Its inputs
are views: x a slice of the conv output and, with one group, B and C
expanded over heads with stride 0.

``ssm_decode`` updates ``cache.state`` in place (JAX returns a new array),
as the port does with KV caches; the returned ``SSMCache`` holds that
tensor.

Tensor parallelism over ``ssm_heads`` (under a plan, ``distributed/
plan.py``): the head-aligned compute layout. The reference splits
``in_proj``'s packed ``z | x | B | C | dt`` columns (and ``conv_w``'s
``x | B | C`` channels) contiguously over ``model``, which does not line
up with heads; the port keeps that stored layout (the checkpoint holds
the reference's global leaves) and gathers both over ``model`` at their
use, then takes a rank's columns: its heads' ``z``, ``x`` and ``dt`` and
all of ``B`` and ``C`` (G groups, expanded over heads and sliced to the
rank's heads). The gradient goes back by a reduce-scatter, a sum over the
ranks: a B or C column's gradient is each rank's heads' part. ``A_log``,
``D``, ``dt_bias``, ``norm`` and ``out_proj``'s rows are split by heads
in the stored layout already and are read as they lie. The gated RMSNorm
runs over all of ``d_inner``: a rank's mean of squares, weighted by its
share of ``d_inner``, is summed over ``model`` (both ways: each rank's
output depends on it), and ``out_proj`` is row-parallel, its partial
product summed by one all-reduce. The SSD kernels run at H/tp heads.

Serving on a plan: the state is split by heads; the conv window keeps
``cache_pspecs``' layout, a contiguous block of the conv_dim channels a
rank (the reference's), so a decode step gathers the stored window and
the new raw inputs' x part over ``model`` (two all-gathers a layer at
tp > 1), convolves its heads' channels and keeps its block of the next
window. Under ``context_parallel`` (B 1) every data rank runs the same
step, its caches replicated over the data axes. Quantised ``in_proj``
and ``conv_w`` are gathered at their stored width (int4 unpacked to int8
after the gather, where a rank's columns are cut at tp > 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import plan as _plan
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dtype_of, rms_norm
from repro_torch.models.params import (ParamSpec, matmul, no_grad, qmm,
                                       stored, use_quantized, use_weight)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_dim) rolling input window
    state: torch.Tensor   # (B, H, hd, ds) f32


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    ds = cfg.ssm_state
    G = cfg.ssm_groups
    conv_dim = di + 2 * G * ds
    proj_dim = 2 * di + 2 * G * ds + H   # z, x, B, C, dt
    return di, H, ds, G, conv_dim, proj_dim


IN_AXES = ("embed", "ssm_heads")
CONV_AXES = ("null", "ssm_heads")


def ssm_spec(cfg: ModelConfig):
    di, H, ds, G, conv_dim, proj_dim = _dims(cfg)
    f32 = torch.float32
    h = ("ssm_heads",)
    return {
        "in_proj": ParamSpec((cfg.d_model, proj_dim), fan_in=cfg.d_model,
                             axes=IN_AXES),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), fan_in=cfg.ssm_conv,
                            axes=CONV_AXES),
        "A_log": ParamSpec((H,), init="zeros", dtype=f32, axes=h),
        "D": ParamSpec((H,), init="zeros", dtype=f32, axes=h),
        "dt_bias": ParamSpec((H,), init="zeros", dtype=f32, axes=h),
        "norm": ParamSpec((di,), init="zeros", dtype=f32, axes=h),
        "out_proj": ParamSpec((di, cfg.d_model), fan_in=di,
                              axes=("ssm_heads", "embed")),
    }


def _local(cfg: ModelConfig):
    """(first head, heads, d_inner) of this rank: all of them with no plan
    or at tp 1."""
    h0, Hl = _plan.tp_block(cfg.ssm_heads)
    return h0, Hl, Hl * cfg.ssm_head_dim


def _split_proj(zxbcdt, cfg: ModelConfig):
    _, Hl, dil = _local(cfg)
    G, ds = cfg.ssm_groups, cfg.ssm_state
    return torch.split(zxbcdt, [dil, dil + 2 * G * ds, Hl], dim=-1)


def _expand_groups(b, cfg: ModelConfig):
    """(.., G, ds) group-projected B/C → per-head (.., H, ds): head h reads
    group h // (H/G), as ``jnp.repeat`` (``repeat_interleave``), then this
    rank's heads. With one group this is a stride-0 view; with more, a
    copy."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    h0, Hl, _ = _local(cfg)
    lead, ds = b.shape[:-2], b.shape[-1]
    out = b.unsqueeze(-2).expand(*lead, G, H // G, ds).flatten(-3, -2)
    return out if Hl == H else out[..., h0:h0 + Hl, :]


def _head_columns(w, starts, cfg: ModelConfig):
    """The columns of this rank's heads of a gathered packed weight: from
    each (start, width, per-head) part of ``starts``, the rank's block of a
    per-head part or all of a shared one."""
    h0, Hl, dil = _local(cfg)
    cols = []
    for start, width, per_head in starts:
        if per_head:
            k = width // cfg.ssm_heads
            cols.append(w[..., start + h0 * k:start + (h0 + Hl) * k])
        else:
            cols.append(w[..., start:start + width])
    return torch.cat(cols, dim=-1)


def _in_parts(cfg: ModelConfig):
    """(start, width, per head) of ``in_proj``'s packed z | x | B | C | dt
    columns."""
    di, H, ds, G, _, _ = _dims(cfg)
    return [(0, di, True), (di, di, True), (2 * di, 2 * G * ds, False),
            (2 * di + 2 * G * ds, H, True)]


def _conv_parts(cfg: ModelConfig):
    """(start, width, per head) of the conv's x | B | C channels."""
    di, _, ds, G, _, _ = _dims(cfg)
    return [(0, di, True), (di, 2 * G * ds, False)]


def _tp() -> bool:
    """Whether a plan splits the heads over more than one rank."""
    pl = _plan.active()
    return pl is not None and pl.tp > 1


def _in_proj(params, x, cfg: ModelConfig):
    """z | x | B | C | dt of this rank's heads: ``x @ in_proj`` as stored
    with no plan or at tp 1; at tp > 1 the weight gathered and cut to this
    rank's heads' columns (a quantised one gathered at its stored width,
    int4 unpacked to int8 after the gather: a head's columns need not
    start on a byte)."""
    dt_ = dtype_of(cfg.dtype)
    x = _plan.enter(x)
    if not _tp():
        return matmul(params, "in_proj", x, dt_, axes=IN_AXES)
    parts, scale = _in_parts(cfg), params.get("in_proj_scale")
    if scale is None:
        w = use_weight(params["in_proj"], IN_AXES, "sum")
        return x @ _head_columns(w, parts, cfg).to(dt_)
    no_grad("in_proj", x)
    w, scale = use_quantized(params["in_proj"], scale, IN_AXES, model=True)
    return qmm(x, _head_columns(stored(w, scale), parts, cfg),
               _head_columns(scale, parts, cfg))


def _conv_w(params, cfg: ModelConfig, dt_):
    """The conv kernel (k, this rank's channels) in ``cfg.dtype``: as
    stored with no plan; under one gathered (at tp > 1 over ``model`` too,
    and cut to this rank's heads' channels). A quantised one is read as
    its raw integers without ``conv_w_scale``, as the reference reads it
    (repro/models/ssm.py:85, :135), on a mesh too."""
    w, scale = params["conv_w"], params.get("conv_w_scale")
    pl = _plan.active()
    if pl is not None:
        tp = pl.tp > 1
        if scale is None:
            w = use_weight(w, CONV_AXES, "sum" if tp else None)
        else:
            w, _ = use_quantized(w, None, CONV_AXES, model=tp)
        w = stored(w, scale)
        if tp:
            w = _head_columns(w, _conv_parts(cfg), cfg)
        return w.to(dt_)
    return stored(w, scale).to(dt_)


def _all_channels(xbc, cfg: ModelConfig):
    """Raw conv inputs of every channel (..., conv_dim) from this rank's
    (its heads' x, all of B and C): at tp > 1 the x part all-gathered over
    ``model`` (heads are contiguous blocks, so in head order)."""
    if not _tp():
        return xbc
    dil = _local(cfg)[2]
    xs, bc = xbc[..., :dil], xbc[..., dil:]
    return torch.cat([_plan.gather_nograd(xs, -1, "model"), bc], dim=-1)


def _window_block(full):
    """This rank's block of a window's conv channels (..., conv_dim): the
    cache's stored layout, ``cache_pspecs``' conv dim over ``model`` (the
    whole window with no plan or at tp 1)."""
    c0, n = _plan.tp_block(full.shape[-1])
    return full if n == full.shape[-1] else full[..., c0:c0 + n]


def _gated_out(params, y, z, cfg: ModelConfig):
    dt_ = dtype_of(cfg.dtype)
    y = rms_norm(y * F.silu(z.float()).to(dt_), params["norm"],
                 cfg.norm_eps, full_dim=cfg.d_inner)
    return _plan.leave(matmul(params, "out_proj", y, dt_,
                              axes=("ssm_heads", "embed")))


def ssm_apply(params, x, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence SSD. x: (B, T, d_model) → (B, T, d_model). With
    ``return_cache`` also returns the SSMCache a decode loop continues from
    (conv window of raw xBC + final SSD state)."""
    B, T, _ = x.shape
    _, _, ds, G, _, _ = _dims(cfg)
    _, Hl, di = _local(cfg)
    conv_dim = di + 2 * G * ds
    dt_ = dtype_of(cfg.dtype)

    zxbcdt = _in_proj(params, x, cfg)
    w = _conv_w(params, cfg, dt_)                 # (k, conv_dim)
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)

    # short causal conv over the (x, B, C) channels
    pad = torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=dt_,
                      device=x.device)
    xp = torch.cat([pad, xBC_raw], dim=1)
    xBC = sum(xp[:, i:i + T] * w[i] for i in range(cfg.ssm_conv))
    xBC = F.silu(xBC)

    xs, Bc, Cc = torch.split(xBC, [di, G * ds, G * ds], dim=-1)
    xs = xs.unflatten(-1, (Hl, cfg.ssm_head_dim))
    Bc = _expand_groups(Bc.unflatten(-1, (G, ds)), cfg)
    Cc = _expand_groups(Cc.unflatten(-1, (G, ds)), cfg)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"])

    y, h_last = kops.ssd(xs, dt, A, Bc, Cc, chunk=cfg.ssm_chunk)
    y = y + params["D"].to(dt_)[None, None, :, None] * xs
    out = _gated_out(params, y.reshape(B, T, di), z, cfg)
    if return_cache:
        # the last d_conv-1 raw inputs in the cache's layout, copied so
        # that xp can be freed
        window = _window_block(_all_channels(xp[:, T:], cfg))
        return out, SSMCache(window.contiguous(), h_last)
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None,
                   device=None, tp: int = 1) -> SSMCache:
    """Zero caches, a rank's part of them at ``tp``: the conv window's
    channels and the state's heads split over ``model`` (``cache_pspecs``)."""
    di, H, ds, G, conv_dim, _ = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim // tp),
                         dtype=dtype or dtype_of(cfg.dtype), device=device),
        state=torch.zeros((batch, H // tp, cfg.ssm_head_dim, ds),
                          dtype=torch.float32, device=device))


def ssm_decode(params, x, cfg: ModelConfig, cache: SSMCache):
    """One-token step: O(1) in context length. x: (B, 1, d_model). Updates
    ``cache.state`` in place. Under a plan at tp > 1 the stored window (its
    block of the conv channels) is gathered over ``model`` and the new raw
    inputs' x part too, so that the rank convolves its heads' channels and
    keeps its block of the next window."""
    B = x.shape[0]
    _, _, ds, G, _, _ = _dims(cfg)
    _, Hl, di = _local(cfg)
    dt_ = dtype_of(cfg.dtype)

    zxbcdt = _in_proj(params, x, cfg)
    z, xBC, dt = _split_proj(zxbcdt, cfg)                 # (B, 1, *)

    full = torch.cat([_all_channels_window(cache.conv),
                      _all_channels(xBC, cfg)], dim=1)    # (B, k, conv)
    window = _head_columns(full, _conv_parts(cfg), cfg) if _tp() else full
    w = _conv_w(params, cfg, dt_)
    xc = F.silu(torch.einsum("bkc,kc->bc", window, w))    # (B, conv)

    xs, Bc, Cc = torch.split(xc, [di, G * ds, G * ds], dim=-1)
    xs = xs.unflatten(-1, (Hl, cfg.ssm_head_dim))
    Bc = _expand_groups(Bc.unflatten(-1, (G, ds)), cfg).float()
    Cc = _expand_groups(Cc.unflatten(-1, (G, ds)), cfg).float()
    dtv = F.softplus(dt.float()[:, 0] + params["dt_bias"][None])   # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dtv * A[None])                      # (B, H)
    upd = dtv[:, :, None, None] * xs.float()[..., None] * Bc[:, :, None, :]
    state = cache.state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bhds,bhs->bhd", state, Cc).to(dt_)
    y = y + params["D"].to(dt_)[None, :, None] * xs
    out = _gated_out(params, y.reshape(B, 1, di), z, cfg)
    return out, SSMCache(_window_block(full[:, 1:]), state)


def _all_channels_window(conv):
    """The stored window's block gathered over ``model`` (tp > 1)."""
    return _plan.gather_nograd(conv, -1, "model") if _tp() else conv
