"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, d_ff=0, vocab=50280, ssm_state=128.
The paper's technique (RFF) is inapplicable: SSD already has a fixed-size
state and no kernel to approximate — runs WITHOUT the technique
(DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    mixer="mamba2",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    rff_long_context=False,  # native fixed-state long context
    preferred_parallelism="dp",
)
