"""Gemma 7B [arXiv:2403.08295; hf].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    mlp_activation="gelu", tie_embeddings=True,
)
