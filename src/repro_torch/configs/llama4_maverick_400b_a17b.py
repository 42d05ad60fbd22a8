"""Llama-4 Maverick 400B-A17B [hf:meta-llama; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
moe_period=2 (alternating dense/MoE) so total params match the 400B name —
the literal every-layer reading gives ~775B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=128, top_k=1, moe_period=2, moe_d_ff=8192,
    rope_theta=500000.0,
)
