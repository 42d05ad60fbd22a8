"""Grouped-query attention with KV cache, rope and qk_norm.

Three entry points, as in ``repro/models/attention.py``:
  * ``attend_full``    — causal self-attention over a whole sequence;
  * ``attend_prefill`` — the same, filling the KV cache;
  * ``attend_decode``  — one new token against the KV cache.

Kernels go through ``kernels.ops`` and so through the dispatch registry:
the CUDA kernel for CUDA tensors, the plain version for CPU tensors, or
what a ``dispatch.using(...)`` scope asks for; with quantised weights the
four projections go through ``quant_matmul`` (``params.matmul``).

Head counts are padded to the tensor-parallel size ``tp`` as the
reference pads them (``ModelConfig.padded_heads/padded_kv_heads``: whole
KV heads replicated where there are fewer than tp). Under a plan
(``distributed/plan.py``) a rank holds H'/tp query heads and K'/tp KV
heads, contiguous, so that GQA groups stay whole on a rank: ``wq``, ``wk``
and ``wv`` are column-parallel (their input enters the region: identity
forward, all-reduce over ``model`` backward), ``wo`` row-parallel (its
partial product summed by one all-reduce over ``model``), and the kernels
run at the local heads. The per-head ``q_norm``/``k_norm`` scales are
replicated, so their gradient, a part on each rank, is summed over
``model`` on entering the region. With no plan and ``tp`` 1 nothing
changes.

Serving under a plan: a rank's cache holds its batch rows and KV heads,
(B/D, S, K'/tp, hd), or under ``context_parallel`` (long_500k, B 1) its
slice of the KV sequence, (1, S/D, K'/tp, hd) (``cache_pspecs``); see
``attend_decode``.

The port updates the KV cache in place (``index_copy_`` / slice assignment)
where JAX returns new arrays; the returned ``KVCache`` holds the same
tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import plan as _plan
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dtype_of, rms_norm
from repro_torch.models.params import ParamSpec, matmul


QKV_AXES = ("embed", "heads", "null")
KV_AXES = ("embed", "kv_heads", "null")
WO_AXES = ("heads", "null", "embed")


def attention_spec(cfg: ModelConfig, tp: int = 1):
    H, K, hd, d = (cfg.padded_heads(tp), cfg.padded_kv_heads(tp),
                   cfg.head_dim, cfg.d_model)
    spec = {
        "wq": ParamSpec((d, H, hd), fan_in=d, axes=QKV_AXES),
        "wk": ParamSpec((d, K, hd), fan_in=d, axes=KV_AXES),
        "wv": ParamSpec((d, K, hd), fan_in=d, axes=KV_AXES),
        "wo": ParamSpec((H, hd, d), fan_in=H * hd, axes=WO_AXES),
    }
    if cfg.qk_norm:
        for k in ("q_norm", "k_norm"):
            spec[k] = ParamSpec((hd,), init="zeros", dtype=torch.float32,
                                axes=("null",))
    return spec


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, K, hd)
    v: torch.Tensor          # (B, S_max, K, hd)
    length: torch.Tensor     # () int32 — filled prefix


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, tp: int = 1, split: int = 1) -> KVCache:
    """Zero caches with the KV heads padded to ``tp``; ``split`` ranks'
    share of them (a plan's ``model`` size: a rank's heads)."""
    shape = (batch, max_len, cfg.padded_kv_heads(tp) // split, cfg.head_dim)
    dtype = dtype or dtype_of(cfg.dtype)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def _proj(params, name: str, x, cfg: ModelConfig):
    """x (B,T,d) · w (d,N,hd) → (B,T,N,hd)."""
    axes = QKV_AXES if name == "wq" else KV_AXES
    y = matmul(params, name, x, dtype_of(cfg.dtype), axes=axes)
    return y.unflatten(-1, (-1, cfg.head_dim))


def _project_qkv(params, x, cfg: ModelConfig, positions):
    x = _plan.enter(x)
    q = _proj(params, "wq", x, cfg)
    k = _proj(params, "wk", x, cfg)
    v = _proj(params, "wv", x, cfg)
    if cfg.qk_norm:              # per-head RMSNorm over head_dim
        q = rms_norm(q, _plan.enter(params["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, _plan.enter(params["k_norm"]), cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(params, out, cfg: ModelConfig):
    """out (B,T,H,hd) · wo (H,hd,d) → (B,T,d), summed over ``model``."""
    return _plan.leave(matmul(params, "wo", out.flatten(-2),
                              dtype_of(cfg.dtype), axes=WO_AXES))


def _positions(B: int, T: int, device):
    return torch.arange(T, dtype=torch.int32, device=device).expand(B, T)


def attend_full(params, x, cfg: ModelConfig):
    """Causal self-attention over a full sequence. x: (B, T, d)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _positions(B, T, x.device))
    out = kops.flash_attention(q, k, v, causal=True)
    return _out(params, out, cfg)


def attend_prefill(params, x, cfg: ModelConfig, cache: KVCache):
    """Full-sequence attention that also fills the KV cache (in place)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, _positions(B, T, x.device))
    out = kops.flash_attention(q, k, v, causal=True)
    cache.k[:, :T] = k
    cache.v[:, :T] = v
    cache = KVCache(cache.k, cache.v,
                    torch.full((), T, dtype=torch.int32, device=x.device))
    return _out(params, out, cfg), cache


def attend_decode(params, x, cfg: ModelConfig, cache: KVCache,
                  context_parallel: bool = False):
    """One-token decode. x: (B, 1, d); ``cache.length`` tokens are filled.

    The new K/V are written at index ``length`` first (in place), then the
    query attends to positions ``<= length``, the new token included. The
    length stays on the device: nothing here waits for the host.

    ``context_parallel`` under a plan (long_500k, B 1): this rank's cache
    is its slice [r·S_l, (r+1)·S_l) of the KV sequence, r its data index.
    Only the rank whose slice holds position ``length`` writes the new K/V
    (a masked write on the device: the others write back what they hold);
    each attends over its slice at its local length, clamped to [-1, S_l)
    (-1: nothing filled), through ``flash_decode``'s LSE route, and
    ``plan.merge_decode`` merges the ranks' rows over ``data``. With no
    plan the flag changes nothing, as the reference's constraint does
    outside a mesh."""
    B, one, _ = x.shape
    if one != 1:
        raise ValueError(f"attend_decode takes one token, got {one}")
    pos = cache.length.expand(B, 1)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos)
    pl = _plan.active()
    if context_parallel and pl is not None:
        S_l = cache.k.shape[1]
        local = cache.length - pl.dp_index * S_l                 # () int32
        mine = (local >= 0) & (local < S_l)
        idx = local.clamp(0, S_l - 1).long().view(1)
        for c, new in ((cache.k, k_new), (cache.v, v_new)):
            c.index_copy_(1, idx, torch.where(mine, new,
                                              c.index_select(1, idx)))
        out, lse = kops.flash_decode(q[:, 0], cache.k, cache.v,
                                     local.clamp(-1, S_l - 1),
                                     with_lse=True)
        out = _plan.merge_decode(out, lse)                       # (B, H, hd)
    else:
        idx = cache.length.long().view(1)
        cache.k.index_copy_(1, idx, k_new)
        cache.v.index_copy_(1, idx, v_new)
        out = kops.flash_decode(q[:, 0], cache.k, cache.v,
                                cache.length)                    # (B, H, hd)
    y = _out(params, out[:, None].to(dtype_of(cfg.dtype)), cfg)
    return y, KVCache(cache.k, cache.v, cache.length + 1)
