"""Configuration: copies of ``ModelConfig``, ``MeshConfig``, ``TrainConfig``,
the input-shape cells (``ShapeConfig``, ``SHAPES``, ``check_applicable``)
and ``with_overrides`` from ``repro/configs/base.py`` (the port imports
nothing from ``repro``). ``TrainConfig`` keeps the reference's defaults exactly
(``adam_b2`` 0.95, ``max_grad_norm`` 1.0); the port's engine reads the jit
tier's fields, and the host, async and checkpoint fields wait for the
slices that port those tiers.

The model code reads only from ``ModelConfig`` — there is no other source
of architecture truth in the port.
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
    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def is_moe_layer(self, i: int) -> bool:
        # MoE on layers where (i % moe_period) == moe_period - 1, matching
        # interleaved dense/MoE stacks (llama4 maverick, jamba).
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

    @property
    def attn_free(self) -> bool:
        return self.ssm_state > 0 and self.attn_period == 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long-context decode? SSM and hybrid stacks can:
        their state is sub-quadratic in context. Pure full-attention archs
        cannot."""
        return self.ssm_state > 0

    # -- TP-aligned (padded) sizes --------------------------------------------
    def padded_heads(self, tp: int) -> int:
        return _round_up(self.num_heads, tp) if self.num_heads else 0

    def padded_kv_heads(self, tp: int) -> int:
        if not self.num_kv_heads:
            return 0
        kv = self.num_kv_heads
        if kv < tp:
            # replicate whole KV heads so each shard owns >= 1 (GQA practice)
            if tp % kv:
                raise ValueError(f"{self.name}: {kv} KV heads do not divide "
                                 f"tp {tp}")
            return tp
        return _round_up(kv, tp)

    def padded_vocab(self, multiple: int = 128) -> int:
        return _round_up(self.vocab_size, multiple)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeConfig("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeConfig("long_500k",   "decode",  524_288, 1),
}


class ShapeNotApplicable(Exception):
    """Raised for (arch, shape) cells excluded by the assignment rules
    (long_500k on pure full-attention archs)."""


def check_applicable(model: ModelConfig, shape: ShapeConfig) -> None:
    if shape.name == "long_500k" and not model.subquadratic:
        raise ShapeNotApplicable(
            f"{model.name} is pure full-attention; long_500k requires a "
            f"sub-quadratic mechanism")


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def data_axes(self) -> tuple:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def tp(self) -> int:
        return dict(zip(self.axes, self.shape)).get("model", 1)

    @property
    def dp(self) -> int:
        d = dict(zip(self.axes, self.shape))
        return d.get("pod", 1) * d.get("data", 1)


@dataclass(frozen=True)
class TrainConfig:
    """PPO / optimization hyperparameters (Clean PuffeRL defaults)."""
    learning_rate: float = 3e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    optimizer_state_dtype: str = "float32"   # "bfloat16" for >100B models

    # PPO
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_coef: float = 0.2
    vf_coef: float = 0.5
    vf_clip: float = 0.2
    ent_coef: float = 0.01
    update_epochs: int = 4
    num_minibatches: int = 4
    norm_adv: bool = True
    target_kl: float = 0.0           # 0 => disabled

    # rollout
    unroll_length: int = 128
    num_envs: int = 64
    pool_buffers: int = 2            # EnvPool double buffering (M = buffers*N)

    # training engine (rl/engine.py)
    updates_per_launch: int = 1      # K: fused updates per host dispatch
    engine_backend: str = "jit"      # jit | shard_map | pool | host | async
    host_recv_timeout: float = 60.0  # host tier: bound on one first-finisher
                                     # batch (turns a hung worker into an
                                     # error instead of a deadlocked run)
    host_backend: str = "thread"     # host tier workers: "thread" (GIL-
                                     # releasing C/sleep steps) | "proc"
                                     # (pure-Python steps; shared-memory
                                     # spawn processes — core/host.py)

    # async actor–learner tier (distributed/actor_learner.py)
    num_actors: int = 2              # spawn actor processes
    shards_per_actor: int = 1        # env shards per actor (num_shards =
                                     # num_actors * shards_per_actor)
    actor_slots: int = 2             # fragment ring depth per shard; small
                                     # on purpose — backpressure bounds how
                                     # stale an actor's next fragment can be
    max_staleness: int = 2           # versions; fragments older than this are
                                     # dropped ("drop") or importance-clipped
                                     # ("vtrace") per staleness_mode
    staleness_mode: str = "drop"     # drop | vtrace
    vtrace_rho: float = 1.0          # rho-bar clamp (vtrace mode)
    vtrace_c: float = 1.0            # c-bar clamp (vtrace mode)
    async_recv_timeout: float = 120.0  # bound on waiting for one update's
                                       # fragments (hang -> error)
    actor_jitter_ms: float = 0.0     # injected per-step actor latency
                                     # (benchmarks / fault injection)

    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3

    # observability (telemetry/http.py)
    metrics_port: int = 0            # 0 = no monitoring server; >0 binds
                                     # /metrics, /healthz, /spans on
                                     # 127.0.0.1:<port> for the run


def with_overrides(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
