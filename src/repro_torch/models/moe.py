"""Mixture-of-Experts: top-k routing with capacity dispatch by index.

Counterpart of ``repro/models/moe.py``, with the same meaning step for step:

* the router's dot runs in x.dtype and is upcast after, the softmax in f32;
* top-k breaks ties as ``jax.lax.top_k`` does, the lower expert index first
  (a stable descending sort, of which the first k);
* the k gates are renormalised over their sum, floored at 1e-9;
* the Switch aux loss counts the top-1 choice only: ``E · Σ me·ce``;
* each (token, choice) pair takes its place in its expert's buffer of C
  slots from a cumsum over the token-major (S·k) order; a pair at or past C
  goes to one extra row that is thrown away;
* the groups are sequences: each has its own C slots an expert;
* the expert FFN is SwiGLU, or tanh-GELU when ``mlp_activation`` is
  ``"gelu"``; the gather back weights each slot by its gate in
  ``cfg.dtype``.

The reference lays the buffer out group-major, (G, E·C + 1, d). The port
lays it out expert-major, E blocks of (G·C, d) and the drop row last, so
that each expert's rows are one contiguous (G·C, d) matrix. Its experts run
as one batched product over E with float weights (the reference's einsums;
no Pallas kernel runs there either). With quantised weights each expert's
slice ``wi[e]`` / ``wo[e]``, a contiguous 2-D int8 or packed int4 weight,
goes through ``kernels.ops.quant_matmul`` over that expert's G·C rows with
the leaf's per-column scale, which all experts share: 2·E launches a layer
and forward, and no dequantised copy of the experts is ever made.

Expert parallelism (under a plan, ``distributed/plan.py``): ``expert`` is
split over ``model``, each rank holding E/tp experts' ``wi``/``wo``. The
router is gathered whole and routing runs on the replicated activations,
so every rank computes the same choices, gates and aux loss; a rank
scatters only the (token, choice) pairs of its own experts into its
buffer (the others go to the drop row), runs its experts, adds its
experts' gated outputs, and one all-reduce over ``model`` sums the ranks'
parts. The tokens and the gates enter that region (their gradients, a
part on each rank, summed over ``model``), so the router's gradient is
whole and the same on every rank. The groups are sequences, so a data
split of the batch keeps each group's capacity exact; the aux loss's two
means over groups are taken over the data ranks (``plan.data_mean``), so
that it is the global batch's, as the reference's is. Serving drops the
aux loss (``aux=False``: not computed, so its two all-reduces are not
issued, as XLA drops the reference's unused ones); quantised, each rank's
experts are gathered over the data axes at their stored width
(``params.use_quantized``) and run through ``quant_matmul`` one by one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import plan as _plan
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import (ParamSpec, no_grad, use_quantized,
                                       use_weight)

ROUTER_AXES = ("embed", "expert")
WI_AXES = ("expert", "embed", "mlp")
WO_AXES = ("expert", "mlp", "embed")


def moe_spec(cfg: ModelConfig):
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, E), fan_in=d, dtype=torch.float32,
                            axes=ROUTER_AXES),
        "wi": ParamSpec((E, d, 2 * f), fan_in=d, axes=WI_AXES),
        "wo": ParamSpec((E, f, d), fan_in=f, axes=WO_AXES),
    }


def capacity(cfg: ModelConfig, group_size: int) -> int:
    c = int(math.ceil(group_size * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(8, ((c + 3) // 4) * 4)   # align a little for layout


def route(params, x, cfg: ModelConfig):
    """x: (G, S, d) → (probs (G,S,E) f32, gate (G,S,k) f32, eidx (G,S,k)
    int64): the router's softmax, the top-k experts of each token (ties to
    the lower index) and their renormalised gates."""
    pl = _plan.active()
    router = use_weight(params["router"], ROUTER_AXES,
                        "slice" if pl is not None and pl.tp > 1 else None)
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    eidx = torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :cfg.top_k]
    gate = probs.gather(-1, eidx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, eidx


def place(eidx, num_experts: int):
    """eidx (G,S,k) → (G,S,k): each (token, choice) pair's place in its
    expert's queue within its group, counted over the token-major (S·k)
    order."""
    G, S, k = eidx.shape
    flat = eidx.reshape(G, S * k)
    pos = F.one_hot(flat, num_experts).cumsum(dim=1)
    return (pos.gather(-1, flat[..., None])[..., 0] - 1).reshape(G, S, k)


def _experts(params, ebuf, cfg: ModelConfig):
    """ebuf (E, R, d) → (E, R, d): each expert's FFN over its R rows."""
    dt = ebuf.dtype
    act = F.silu if cfg.mlp_activation == "silu" else \
        (lambda g: F.gelu(g, approximate="tanh"))
    wi_s, wo_s = params.get("wi_scale"), params.get("wo_scale")
    if wi_s is None:
        wi = use_weight(params["wi"], WI_AXES)
        wo = use_weight(params["wo"], WO_AXES)
        g, u = torch.bmm(ebuf, wi.to(dt)).chunk(2, dim=-1)
        return torch.bmm(act(g) * u, wo.to(dt))
    # this rank's experts at their stored width, gathered over the data
    # axes, with the scales whole (shared by every expert)
    no_grad("wi", ebuf)
    wi, wi_s = use_quantized(params["wi"], wi_s, WI_AXES)
    wo, wo_s = use_quantized(params["wo"], wo_s, WO_AXES)
    ys = []
    for e in range(ebuf.shape[0]):
        g, u = kops.quant_matmul(ebuf[e], wi[e], wi_s).chunk(2, dim=-1)
        ys.append(kops.quant_matmul(act(g) * u, wo[e], wo_s))
    return torch.stack(ys)


def moe_apply(params, x, cfg: ModelConfig, aux: bool = True):
    """x: (G, S, d), one group a sequence. Returns (y (G,S,d) in x.dtype,
    aux loss () f32, or None without ``aux``)."""
    G, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity(cfg, S)
    dt = dtype_of(cfg.dtype)

    probs, gate, eidx = route(params, x, cfg)
    if aux:
        me = _plan.data_mean(probs.mean(dim=(0, 1)))              # (E,)
        ce = _plan.data_mean((F.one_hot(eidx[..., 0], E).float().sum(dim=1)
                              / S).mean(dim=0))
        aux = E * torch.sum(me * ce)
    else:
        aux = None

    # each (token, choice) pair's slot: its expert's block among this
    # rank's El experts, its group's C rows there, its place in the queue;
    # at or past C, or another rank's expert, the drop row
    pos = place(eidx, E)
    e0, El = _plan.tp_block(E)
    g_off = torch.arange(G, device=x.device)[:, None, None] * C
    R = G * C                                      # an expert's rows
    mine = (eidx >= e0) & (eidx < e0 + El) & (pos < C)
    slot = torch.where(mine, (eidx - e0) * R + g_off + pos,
                       torch.full_like(pos, El * R)).reshape(-1)  # (G·S·k,)

    # scatter tokens into the slots (the extra row El·R swallows drops)
    src = _plan.enter(x).to(dt).repeat_interleave(k, dim=1).reshape(-1, d)
    buf = torch.zeros((El * R + 1, d), dtype=dt, device=x.device)
    buf = buf.index_add(0, slot, src)
    y = _experts(params, buf[:El * R].view(El, R, d), cfg)

    # gather back: each token takes its k slots, weighted by its gates
    ypad = torch.cat([y.reshape(El * R, d), y.new_zeros((1, d))])
    out = ypad[slot].view(G, S, k, d)
    out = (out * _plan.enter(gate)[..., None].to(dt)).sum(dim=2)
    return _plan.leave(out).to(x.dtype), aux
