"""LM substrate: the unified decoder covering all ten archs and its loss
(``repro.models``' exports)."""
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
    lm_loss,
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
    "lm_loss",
    "with_rff_attention",
]
