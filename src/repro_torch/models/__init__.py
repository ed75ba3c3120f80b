"""LM substrate: the unified decoder covering all ten archs (``repro``'s
exports but ``lm_loss``, the training half; ROADMAP §1 entry 7)."""
from repro_torch.models import (
    attention,
    layers,
    moe,
    rff_attention,
    rglru,
    ssm,
)
from repro_torch.models.transformer import (
    decode_state_init,
    decode_step,
    forward,
    init_params,
    with_rff_attention,
)

__all__ = [
    "attention",
    "layers",
    "moe",
    "rff_attention",
    "rglru",
    "ssm",
    "decode_state_init",
    "decode_step",
    "forward",
    "init_params",
    "with_rff_attention",
]
