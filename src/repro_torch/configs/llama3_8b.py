"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope theta 500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    attention="gqa",
    rope_theta=500_000.0,
    # train deployment: FSDP over all 256 chips (weight-gather bytes are
    # far below TP-16 Megatron activation-AR bytes at this size; see
    # EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
)
