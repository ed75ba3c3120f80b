"""qwen2-0.5b [dense] — GQA with QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    attention="gqa",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    preferred_parallelism="dp",
)
