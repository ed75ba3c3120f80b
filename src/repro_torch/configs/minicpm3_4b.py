"""minicpm3-4b [dense] — deep-thin MLA [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA with kv_lora_rank=256,
q_lora_rank=768, qk 64+32, v 64 (HF config values).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    pad_heads_to=48,
    mla=MLAConfig(
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    # train deployment: FSDP over all 256 chips (2.7-5.8x better modelled
    # step time than TP-16; see EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
)
