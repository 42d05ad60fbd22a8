"""Jamba v0.1 52B [arXiv:2403.19887; hf]. Mamba+attention 1:7, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; attention every 8th
layer (1:7 interleave), MoE every 2nd layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    num_experts=16, top_k=2, moe_period=2, moe_d_ff=14336,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, attn_period=8,
    use_rope=False,
)
