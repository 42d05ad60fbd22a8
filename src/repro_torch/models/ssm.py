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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dtype_of, rms_norm
from repro_torch.models.params import ParamSpec, matmul, stored


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


def ssm_spec(cfg: ModelConfig):
    di, H, ds, G, conv_dim, proj_dim = _dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((cfg.d_model, proj_dim), fan_in=cfg.d_model),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), fan_in=cfg.ssm_conv),
        "A_log": ParamSpec((H,), init="zeros", dtype=f32),
        "D": ParamSpec((H,), init="zeros", dtype=f32),
        "dt_bias": ParamSpec((H,), init="zeros", dtype=f32),
        "norm": ParamSpec((di,), init="zeros", dtype=f32),
        "out_proj": ParamSpec((di, cfg.d_model), fan_in=di),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, H, _, _, conv_dim, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, conv_dim, H], dim=-1)   # z, xBC, dt


def _expand_groups(b, cfg: ModelConfig):
    """(.., G, ds) group-projected B/C → per-head (.., H, ds): head h reads
    group h // (H/G), as ``jnp.repeat`` (``repeat_interleave``). With one
    group this is a stride-0 view; with more, a copy."""
    H, G = cfg.ssm_heads, cfg.ssm_groups
    lead, ds = b.shape[:-2], b.shape[-1]
    return b.unsqueeze(-2).expand(*lead, G, H // G, ds).flatten(-3, -2)


def _gated_out(params, y, z, cfg: ModelConfig):
    dt_ = dtype_of(cfg.dtype)
    y = rms_norm(y * F.silu(z.float()).to(dt_), params["norm"],
                 cfg.norm_eps)
    return matmul(params, "out_proj", y, dt_)


def _conv_w(params, dt_):
    """The conv kernel (k, conv_dim) in ``cfg.dtype``. A quantised one is
    read as its raw integers without ``conv_w_scale``, as the reference
    reads it (repro/models/ssm.py:85, :135)."""
    return stored(params["conv_w"], params.get("conv_w_scale")).to(dt_)


def ssm_apply(params, x, cfg: ModelConfig, return_cache: bool = False):
    """Full-sequence SSD. x: (B, T, d_model) → (B, T, d_model). With
    ``return_cache`` also returns the SSMCache a decode loop continues from
    (conv window of raw xBC + final SSD state)."""
    B, T, _ = x.shape
    di, H, ds, G, conv_dim, _ = _dims(cfg)
    dt_ = dtype_of(cfg.dtype)

    zxbcdt = matmul(params, "in_proj", x, dt_)
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)

    # short causal conv over the (x, B, C) channels
    w = _conv_w(params, dt_)                          # (k, conv_dim)
    pad = torch.zeros((B, cfg.ssm_conv - 1, conv_dim), dtype=dt_,
                      device=x.device)
    xp = torch.cat([pad, xBC_raw], dim=1)
    xBC = sum(xp[:, i:i + T] * w[i] for i in range(cfg.ssm_conv))
    xBC = F.silu(xBC)

    xs, Bc, Cc = torch.split(xBC, [di, G * ds, G * ds], dim=-1)
    xs = xs.unflatten(-1, (H, cfg.ssm_head_dim))
    Bc = _expand_groups(Bc.unflatten(-1, (G, ds)), cfg)
    Cc = _expand_groups(Cc.unflatten(-1, (G, ds)), cfg)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"])

    y, h_last = kops.ssd(xs, dt, A, Bc, Cc, chunk=cfg.ssm_chunk)
    y = y + params["D"].to(dt_)[None, None, :, None] * xs
    out = _gated_out(params, y.reshape(B, T, di), z, cfg)
    if return_cache:
        # the last d_conv-1 raw inputs, copied so that xp can be freed
        return out, SSMCache(xp[:, T:].contiguous(), h_last)
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None,
                   device=None) -> SSMCache:
    di, H, ds, G, conv_dim, _ = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                         dtype=dtype or dtype_of(cfg.dtype), device=device),
        state=torch.zeros((batch, H, cfg.ssm_head_dim, ds),
                          dtype=torch.float32, device=device))


def ssm_decode(params, x, cfg: ModelConfig, cache: SSMCache):
    """One-token step: O(1) in context length. x: (B, 1, d_model). Updates
    ``cache.state`` in place."""
    B = x.shape[0]
    di, H, ds, G, conv_dim, _ = _dims(cfg)
    dt_ = dtype_of(cfg.dtype)

    zxbcdt = matmul(params, "in_proj", x, dt_)
    z, xBC, dt = _split_proj(zxbcdt, cfg)                 # (B, 1, *)

    window = torch.cat([cache.conv, xBC], dim=1)          # (B, k, conv)
    w = _conv_w(params, dt_)
    xc = F.silu(torch.einsum("bkc,kc->bc", window, w))    # (B, conv)

    xs, Bc, Cc = torch.split(xc, [di, G * ds, G * ds], dim=-1)
    xs = xs.unflatten(-1, (H, cfg.ssm_head_dim))
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
    return out, SSMCache(window[:, 1:], state)
