"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=2048. The EnCodec
frontend is a stub: inputs arrive as precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    attention="gqa",
    frontend="audio",
    # train deployment: FSDP over all 256 chips (2.7-5.8x better modelled
    # step time than TP-16; see EXPERIMENTS.md section Perf)
    train_parallelism="fsdp",
)
