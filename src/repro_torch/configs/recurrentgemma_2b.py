"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
sliding window 2048. Pattern: (recurrent, recurrent, local-attn) repeating —
8 scanned groups + 2 remainder recurrent blocks.

Fixed-size recurrent state + bounded attention window => native long-context
decode (no RFF substitution needed).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    pad_heads_to=16,
    attention="gqa",
    mixer="rglru_hybrid",
    lru_width=2560,
    local_window=2048,
    attn_every=3,
    rff_long_context=False,  # native fixed-state long context
    # train deployment: FSDP over all 256 chips (weight-gather bytes are
    # far below TP-16 Megatron activation-AR bytes at this size; see
    # EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
)
