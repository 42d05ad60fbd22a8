"""Shared layers: norms, rotary embeddings, embeddings, gated MLP.

Numerics follow ``repro/models/layers.py`` step for step, so bf16 rounds at
the same places: the norm's variance in f32 with the products in x.dtype,
rope in f32, the embedding scale as a ``cfg.dtype`` scalar, logits in f32.
Matmul weights go through ``params.matmul`` (``quant_matmul`` when
quantised); quantised embedding rows are dequantised in bf16 after the
gather, as the reference dequantises its table.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, matmul, stored


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``) → ``torch.bfloat16``."""
    return getattr(torch, name)


def rms_norm(x, scale, eps: float = 1e-6):
    # f32 only for the (…,1) variance reduction; the wide elementwise math
    # stays in x.dtype. The scale is stored as (scale - 1).
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    w = 1.0 + scale.float()
    return x * inv.to(x.dtype) * w.to(x.dtype)


def rms_norm_spec(dim: int) -> ParamSpec:
    # stored as (scale - 1) so zero-init == identity
    return ParamSpec((dim,), init="zeros", dtype=torch.float32)


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
                               fan_in=cfg.d_model)}


def embed_tokens(params, tokens, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    scale = params.get("embed_scale")
    x = stored(params["embed"][tokens], scale)
    if scale is not None:
        # the gathered rows dequantised in bf16 whatever cfg.dtype, as the
        # reference's weight() does (repro/models/params.py:199-205)
        bf = torch.bfloat16
        x = x.to(bf) * scale.to(bf)
    x = x.to(dt)
    # the scale is rounded to cfg.dtype before the product, as in JAX;
    # torch.full fills on the device (no host-to-device copy, no sync)
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=dt,
                          device=x.device)


def unembed_spec(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"unembed": ParamSpec((cfg.d_model, cfg.padded_vocab()),
                                 fan_in=cfg.d_model)}


def unembed(params, embed_params, x, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    if cfg.tie_embeddings:      # x @ E.T: the (V, d) table in the (N, K) layout
        y = matmul(embed_params, "embed", x, dt, transposed=True)
    else:
        y = matmul(params, "unembed", x, dt)
    return y.float()


# -- gated MLP (SwiGLU / GeGLU) -----------------------------------------------

def make_mlp_spec(cfg: ModelConfig, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    return {
        "wi": ParamSpec((cfg.d_model, 2 * d_ff), fan_in=cfg.d_model),
        "wo": ParamSpec((d_ff, cfg.d_model), fan_in=d_ff),
    }


def mlp_apply(params, x, cfg: ModelConfig):
    dt = dtype_of(cfg.dtype)
    h = matmul(params, "wi", x, dt)
    gate, up = h.chunk(2, dim=-1)
    act = F.silu(gate) if cfg.mlp_activation == "silu" \
        else F.gelu(gate, approximate="tanh")
    return matmul(params, "wo", act * up, dt)
