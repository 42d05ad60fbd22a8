"""Architecture registry of the port.

``get_config(arch)`` returns the exact full-size config; ``get_smoke_config``
returns the reduced same-family config for CPU smoke tests, by the same rule
as ``repro.configs``. All ten of the reference's archs are registered, in
its order; gemma-7b (head dim 256) and stablelm-12b (head dim 160) take the
attention kernels' instances at those head dims.
"""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      ShapeNotApplicable, check_applicable,
                                      with_overrides)
from repro_torch.configs import (dbrx_132b, gemma_7b, internlm2_20b,
                                 internvl2_26b, jamba_v0p1_52b,
                                 llama4_maverick_400b_a17b, mamba2_1p3b,
                                 musicgen_medium, qwen3_0p6b, stablelm_12b)

_MODULES = {
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "dbrx-132b": dbrx_132b,
    "mamba2-1.3b": mamba2_1p3b,
    "gemma-7b": gemma_7b,
    "internlm2-20b": internlm2_20b,
    "stablelm-12b": stablelm_12b,
    "qwen3-0.6b": qwen3_0p6b,
    "internvl2-26b": internvl2_26b,
    "musicgen-medium": musicgen_medium,
    "jamba-v0.1-52b": jamba_v0p1_52b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced config of the same family, runnable on one CPU core."""
    cfg = get_config(arch)
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=2 if cfg.num_kv_heads else 0,
        frontend_prefix=8 if cfg.frontend else 0,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=256)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn_period:
        kw.update(attn_period=2, num_layers=4)
    if cfg.moe_period > 1:
        kw.update(moe_period=2)
    return with_overrides(cfg, **kw)


__all__ = ["ModelConfig", "with_overrides", "ARCHS", "get_config",
           "get_smoke_config"]
