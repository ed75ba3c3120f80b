"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    # train deployment: FSDP over all 256 chips (weight-gather bytes are
    # far below TP-16 Megatron activation-AR bytes at this size; see
    # EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
    attention="gqa",
)
