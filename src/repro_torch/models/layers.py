"""Shared layers: norms, rotary embeddings, embeddings, gated MLP.

Numerics follow ``repro/models/layers.py`` step for step, so bf16 rounds at
the same places: the norm's variance in f32 with the products in x.dtype,
rope in f32, the embedding scale as a ``cfg.dtype`` scalar, logits in f32.
Matmul weights go through ``params.matmul`` (``quant_matmul`` when
quantised); quantised embedding rows are dequantised in bf16 after the
gather, as the reference dequantises its table.

Under a plan (``distributed/plan.py``) the layers are Megatron's: the MLP's
``wi`` column-parallel on ``mlp`` (each rank the gate and up columns of
its block of d_ff: ``wi`` is stored in the reference's layout, whose
contiguous split gives a rank gate or up columns, so it is gathered over
``model`` at its use and its gradient reduce-scattered back), ``wo``
row-parallel with one all-reduce; the embedding vocab-parallel (each rank
looks up the ids in its vocab rows, zeros the rest, one all-reduce) and
the unembed column-parallel over the vocab (each rank its logits' block).
Quantised, the embedding's rows are dequantised after the rank's lookup
in its vocab block, and the MLP's ``wi`` at tp > 1 is gathered at its
stored width and cut to the rank's gate and up columns (int4 unpacked to
int8 first: a rank's columns need not start on a byte).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import plan as _plan
from repro_torch.models.params import (ParamSpec, matmul, no_grad, qmm,
                                       stored, use_quantized, use_weight)


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``) → ``torch.bfloat16``."""
    return getattr(torch, name)


def rms_norm(x, scale, eps: float = 1e-6, full_dim: int = 0):
    # f32 only for the (…,1) variance reduction; the wide elementwise math
    # stays in x.dtype. The scale is stored as (scale - 1).
    var = x.float().square().mean(dim=-1, keepdim=True)
    if full_dim and _plan.active() is not None:
        # x is this rank's part of a dim of full_dim split over ``model``:
        # its mean weighted by its share (1.0 at tp 1), summed over model
        var = _plan.reduce(var * (x.shape[-1] / full_dim))
    inv = torch.rsqrt(var + eps)
    w = 1.0 + scale.float()
    return x * inv.to(x.dtype) * w.to(x.dtype)


def rms_norm_spec(dim: int, axes=("embed",)) -> ParamSpec:
    # stored as (scale - 1) so zero-init == identity
    return ParamSpec((dim,), init="zeros", dtype=torch.float32,
                     axes=tuple(axes))


def norm(params, name: str, x, cfg: ModelConfig):
    """``rms_norm`` of x by the ``embed``-axis scale ``params[name]``, read
    at its use site (FSDP-gathered under a plan)."""
    return rms_norm(x, use_weight(params[name], ("embed",)), cfg.norm_eps)


# -- rotary -------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: (..., T) int. Rotates the two halves
    of each head (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (...,T,hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (...,T,1,hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding ----------------------------------------------------------------

def embedding_spec(cfg: ModelConfig):
    return {"embed": ParamSpec((cfg.padded_vocab(), cfg.d_model),
                               fan_in=cfg.d_model, axes=("vocab", "embed"))}


def _rows(w, ids, scale, dt):
    """Rows ``ids`` of the table ``w`` in ``dt``; a quantised table's rows
    dequantised in bf16 whatever ``dt``, as the reference's weight() does
    (repro/models/params.py:199-205)."""
    x = stored(w[ids], scale)
    if scale is not None:
        bf = torch.bfloat16
        x = x.to(bf) * scale.to(bf)
    return x.to(dt)


def _embed_rows(w, tokens, cfg: ModelConfig, dt, scale=None):
    """The rows of ``tokens`` from this rank's vocab block of the table,
    zero where another rank holds the id, summed over ``model``."""
    v0, n = _plan.tp_block(cfg.padded_vocab())
    ids = tokens.long() - v0
    inside = (ids >= 0) & (ids < n)
    x = _rows(w, ids.clamp(0, n - 1), scale, dt)
    return _plan.leave(torch.where(inside[..., None], x, x.new_zeros(())))


def embed_tokens(params, tokens, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    scale = params.get("embed_scale")
    if _plan.active() is not None:
        axes = ("vocab", "embed")
        if scale is None:
            w = use_weight(params["embed"], axes)
        else:
            w, scale = use_quantized(params["embed"], scale, axes)
        x = _embed_rows(w, tokens, cfg, dt, scale)
        return x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                              device=x.device)
    x = _rows(params["embed"], tokens, scale, dt)
    # the scale is rounded to cfg.dtype before the product, as in JAX;
    # torch.full fills on the device (no host-to-device copy, no sync)
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                          device=x.device)


def unembed_spec(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"unembed": ParamSpec((cfg.d_model, cfg.padded_vocab()),
                                 fan_in=cfg.d_model, axes=("embed", "vocab"))}


def unembed(params, embed_params, x, cfg: ModelConfig):
    """Logits (..., V) f32; under a plan this rank's vocab block of them."""
    dt = dtype_of(cfg.dtype)
    x = _plan.enter(x)
    if cfg.tie_embeddings:      # x @ E.T: the (V, d) table in the (N, K) layout
        y = matmul(embed_params, "embed", x, dt, transposed=True,
                   axes=("vocab", "embed"))
    else:
        y = matmul(params, "unembed", x, dt, axes=("embed", "vocab"))
    return y.float()


# -- gated MLP (SwiGLU / GeGLU) -----------------------------------------------

def make_mlp_spec(cfg: ModelConfig, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    return {
        "wi": ParamSpec((cfg.d_model, 2 * d_ff), fan_in=cfg.d_model,
                        axes=("embed", "mlp")),
        "wo": ParamSpec((d_ff, cfg.d_model), fan_in=d_ff,
                        axes=("mlp", "embed")),
    }


def mlp_apply(params, x, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    pl = _plan.active()
    if pl is not None and pl.tp > 1:
        # this rank's gate and up columns of the gathered (d, 2F) weight
        scale = params.get("wi_scale")
        if scale is None:
            wi = use_weight(params["wi"], ("embed", "mlp"), model="sum")
        else:
            # int4 unpacked to int8 after its packed gather: a rank's
            # columns need not start on a byte
            no_grad("wi", x)
            wi, scale = use_quantized(params["wi"], scale, ("embed", "mlp"),
                                      model=True)
            wi = stored(wi, scale)
        f = wi.shape[1] // 2
        f0, n = _plan.tp_block(f)
        cols = lambda t: torch.cat([t[..., f0:f0 + n],
                                    t[..., f + f0:f + f0 + n]], dim=-1)
        if scale is None:
            h = _plan.enter(x) @ cols(wi).to(dt)
        else:
            h = qmm(_plan.enter(x), cols(wi), cols(scale))
    else:
        h = matmul(params, "wi", _plan.enter(x), dt, axes=("embed", "mlp"))
    gate, up = h.chunk(2, dim=-1)
    act = F.silu(gate) if cfg.mlp_activation == "silu" \
        else F.gelu(gate, approximate="tanh")
    return _plan.leave(matmul(params, "wo", act * up, dt,
                              axes=("mlp", "embed")))
