"""MusicGen medium [arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens.

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. The EnCodec frontend is a
STUB: the batch carries precomputed
frame embeddings (``models/frontends.py::stub_prefix``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, mlp_activation="gelu",
    frontend="audio", frontend_prefix=256,
)
