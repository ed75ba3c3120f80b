"""LM substrate: the decoder for dense attention-mixer archs (gqa or rff
attention)."""
from repro_torch.models import attention, layers, rff_attention
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
    "rff_attention",
    "decode_state_init",
    "decode_step",
    "forward",
    "init_params",
    "with_rff_attention",
]
