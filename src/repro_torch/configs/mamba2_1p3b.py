"""Mamba2 1.3B [arXiv:2405.21060; unverified]. SSD, attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128.
Mamba2 blocks replace attention+MLP; d_ff=0 per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, attn_period=0,
)
