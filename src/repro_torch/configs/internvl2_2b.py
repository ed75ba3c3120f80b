"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone only (InternLM2-1.8B): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. The ViT frontend is a stub: inputs arrive as precomputed patch
embeddings (B, S, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    attention="gqa",
    frontend="vision",
    # train deployment: FSDP over all 256 chips (2.7-5.8x better modelled
    # step time than TP-16; see EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
)
