"""DBRX 132B [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
(fine-grained, every layer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    num_experts=16, top_k=4, moe_period=1, moe_d_ff=10752,
    rope_theta=500000.0,
)
