"""InternVL2 26B [arXiv:2404.16821; hf]. InternViT frontend + InternLM2-20B.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT vision tower is a STUB frontend: the batch carries
precomputed patch embeddings (``models/frontends.py::stub_prefix``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, rope_theta=1000000.0,
    frontend="vlm", frontend_prefix=256,
)
