"""Modality frontend stubs, the counterpart of ``repro/models/frontends.py``.

The vlm and audio archs specify the transformer backbone only: their batches
carry precomputed patch or frame embeddings, which ``transformer.forward``
and ``prefill`` put before the token embeddings. ``stub_prefix`` fabricates
such a prefix for smoke runs and tests.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of


def stub_prefix(cfg: ModelConfig, generator: torch.Generator, batch: int):
    """Precomputed frame / patch embeddings: (B, P, d_model) in
    ``cfg.dtype``, normal × 0.02, drawn in f32 on the generator's device and
    cast before the product, as the reference casts."""
    if cfg.frontend not in ("vlm", "audio"):
        raise ValueError(f"{cfg.name} has no frontend (frontend="
                         f"{cfg.frontend!r})")
    x = torch.randn((batch, cfg.frontend_prefix, cfg.d_model),
                    generator=generator, device=generator.device)
    return x.to(dtype_of(cfg.dtype)) * 0.02
