"""Backbone assembler: the dense transformer stack.

Counterpart of ``repro/models/transformer.py``. JAX scans a stacked
``(n_periods, …)`` parameter tree; the port keeps one parameter tree per
layer (``layers.0`` … ``layers.{L-1}``) and runs a Python loop over layers.
MoE and SSM layers arrive with the LM-backbone training slice and raise
``NotImplementedError`` until then.

Three entry points: ``forward`` (full sequence), ``prefill`` (build caches),
``decode`` (one token against caches).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec


def layer_kinds(cfg: ModelConfig, i: int):
    if not cfg.is_attn_layer(i):
        raise NotImplementedError(
            f"{cfg.name}: SSM layers arrive with the LM-backbone training "
            f"slice of the port")
    if cfg.is_moe_layer(i):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers arrive with the LM-backbone training "
            f"slice of the port")
    return "attn", (None if cfg.d_ff == 0 else "mlp")


def _norm_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), init="zeros", dtype=torch.float32)


def transformer_spec(cfg: ModelConfig):
    layers = {}
    for i in range(cfg.num_layers):
        _, ffn = layer_kinds(cfg, i)
        l = {"ln_mix": _norm_spec(cfg), "attn": attn.attention_spec(cfg)}
        if ffn == "mlp":
            l["ln_ffn"] = _norm_spec(cfg)
            l["mlp"] = L.make_mlp_spec(cfg)
        layers[str(i)] = l
    spec = {"embedding": L.embedding_spec(cfg), "layers": layers,
            "final_norm": _norm_spec(cfg)}
    spec.update(L.unembed_spec(cfg))
    return spec


def _ffn(p, x, cfg: ModelConfig):
    if "mlp" not in p:
        return x
    h = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg)


def forward(params, tokens, cfg: ModelConfig):
    """Full-sequence forward. tokens: (B, T). Returns (hidden (B,T,d),
    aux dict)."""
    x = L.embed_tokens(params["embedding"], tokens, cfg)
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        h = L.rms_norm(x, p["ln_mix"], cfg.norm_eps)
        x = x + attn.attend_full(p["attn"], h, cfg)
        x = _ffn(p, x, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_aux": torch.zeros((), device=x.device)}


def logits_from_hidden(params, x, cfg: ModelConfig):
    logits = L.unembed(params, params["embedding"], x, cfg)
    v = cfg.padded_vocab()
    if v != cfg.vocab_size:   # mask the padded vocab
        mask = torch.arange(v, device=x.device) < cfg.vocab_size
        logits = logits.masked_fill(~mask, -1e30)
    return logits


# -- caches -------------------------------------------------------------------

class Caches(NamedTuple):
    kv: List[attn.KVCache]   # one per layer
    length: torch.Tensor     # () int32 on the device: filled prefix


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> Caches:
    kv = [attn.init_cache(cfg, batch, max_len, device=device)
          for _ in range(cfg.num_layers)]
    return Caches(kv, torch.zeros((), dtype=torch.int32, device=device))


def prefill(params, tokens, cfg: ModelConfig, max_len: int = 0):
    """Forward + cache build. tokens: (B, T). Returns (hidden, caches)."""
    x = L.embed_tokens(params["embedding"], tokens, cfg)
    B, T, _ = x.shape
    caches = init_caches(cfg, B, max_len or T, device=x.device)
    kv = []
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        h = L.rms_norm(x, p["ln_mix"], cfg.norm_eps)
        y, c = attn.attend_prefill(p["attn"], h, cfg, caches.kv[i])
        kv.append(c)
        x = _ffn(p, x + y, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, Caches(kv, torch.full((), T, dtype=torch.int32,
                                    device=x.device))


def decode(params, tokens, cfg: ModelConfig, caches: Caches):
    """One-token step. tokens: (B, 1). Returns (hidden, caches). As in JAX,
    each layer attends at the global ``caches.length``; the per-layer
    lengths come back zeroed and the global one is incremented."""
    x = L.embed_tokens(params["embedding"], tokens, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    kv = []
    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        h = L.rms_norm(x, p["ln_mix"], cfg.norm_eps)
        y, c = attn.attend_decode(p["attn"], h, cfg,
                                  caches.kv[i]._replace(length=caches.length))
        kv.append(c._replace(length=zero))
        x = _ffn(p, x + y, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, Caches(kv, caches.length + 1)
