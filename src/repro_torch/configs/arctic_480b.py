"""arctic-480b [moe] — Snowflake Arctic: dense residual + 128e top-2 MoE
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; every layer runs a
dense FFN residually in parallel with a 128-expert top-2 MoE.

bf16 optimizer moments (opt_dtype) — at 480B params the f32-moment AdamW
state would exceed v5e HBM at 256 chips; see EXPERIMENTS.md memory notes.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    pad_heads_to=64,
    attention="gqa",
    moe=MoEConfig(
        num_experts=128, top_k=2, d_ff_expert=4864, dense_residual_ff=4864
    ),
    opt_dtype="bfloat16",
    zero_stage=3,
    # 4 microbatches (64-seq micro, 4 seqs/device): amortizes the ZeRO-3
    # per-use expert-weight all-gathers 4x vs 1-seq microbatches (see
    # EXPERIMENTS.md section Perf, cell A)
    train_microbatches=4,
)
