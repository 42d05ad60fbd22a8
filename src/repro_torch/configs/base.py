"""Model configuration: a copy of ``ModelConfig`` and ``with_overrides`` from
``repro/configs/base.py`` (the port imports nothing from ``repro``).

The model code reads only from this dataclass — there is no other source of
architecture truth in the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Backbone definition for a token-level policy."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # -- attention details --------------------------------------------------
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    use_rope: bool = True            # jamba: no positional encoding
    rope_theta: float = 10_000.0
    mlp_activation: str = "silu"     # silu => SwiGLU, gelu => GeGLU
    attn_logit_softcap: float = 0.0

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_period: int = 1              # every `moe_period`-th layer is MoE
    moe_d_ff: int = 0                # expert hidden (defaults to d_ff)
    capacity_factor: float = 1.25

    # -- SSM (mamba2) ---------------------------------------------------------
    ssm_state: int = 0               # d_state; 0 => no SSM layers
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1              # B/C projection groups
    ssm_chunk: int = 128             # SSD chunk length
    attn_period: int = 0             # hybrid: every `attn_period`-th layer is
                                     # attention (jamba: 8 => 1:7), 0 => none

    # -- modality frontend (stub) ---------------------------------------------
    frontend: Optional[str] = None   # "vlm" | "audio"
    frontend_prefix: int = 256       # precomputed embedding prefix length

    # -- numerics / memory ----------------------------------------------------
    dtype: str = "bfloat16"          # activation dtype
    param_dtype: str = "bfloat16"
    remat: str = "full"              # full | dots | none
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # -- RL policy head -------------------------------------------------------
    value_head: bool = True          # PPO critic head

    # Derived -----------------------------------------------------------------
    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid stacks: which layers are attention (rest are SSM)."""
        if self.ssm_state == 0:
            return True              # pure transformer
        if self.attn_period == 0:
            return False             # pure SSM
        return (i % self.attn_period) == (self.attn_period - 1)

    def padded_vocab(self, multiple: int = 128) -> int:
        return _round_up(self.vocab_size, multiple)


def with_overrides(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
