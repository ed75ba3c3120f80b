"""Decoder-only LM assembled from a ModelConfig.

Counterpart of ``repro/models/transformer.py`` for ``mixer="attention"``
with a dense (SwiGLU) FFN and gqa or rff attention: qwen2-0.5b and
llama3-8b, as published or switched to RFF attention by
:func:`with_rff_attention`. The layers are a Python loop over a list of
per-layer dicts (``params["blocks"]``); ``repro`` scans stacked layers
under jit. MoE, MLA, mamba2 and the rglru hybrid raise
``NotImplementedError`` (ROADMAP §1 item 11).

``forward`` and ``decode_step`` take ``kernel_mode`` ("auto", "cuda" or
"ref") and pass it to the attention kernels, so the same model can run the
kernels or their plain versions on the card.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rff_attention as rff_mod
from repro_torch.models.layers import (
    dense,
    dense_init,
    embed_init,
    glu_mlp,
    glu_mlp_init,
    rmsnorm,
    rmsnorm_init,
)

__all__ = [
    "with_rff_attention",
    "init_params",
    "apply_stack",
    "head_logits",
    "forward",
    "decode_state_init",
    "decode_step",
]


def with_rff_attention(cfg: ModelConfig) -> ModelConfig:
    """Switch a full-attention config to RFF linear attention (the paper's
    fixed-size-state technique)."""
    return replace(cfg, attention="rff")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of ``repro``'s model the port does not run."""
    missing = None
    if cfg.mixer != "attention":
        missing = f"mixer {cfg.mixer!r}"
    elif cfg.moe is not None:
        missing = "the MoE FFN"
    elif cfg.attention not in ("gqa", "rff"):
        missing = f"attention {cfg.attention!r}"
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {missing} is not ported to repro_torch (ROADMAP §1 "
            "item 11: MLA, MoE, mamba2 and rglru wait)"
        )


def _block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    if cfg.attention == "rff":
        attn = rff_mod.rff_attn_init(gen, cfg, dtype, device=device)
    else:
        attn = attn_mod.gqa_init(gen, cfg, dtype, device=device)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn,
        "ln2": rmsnorm_init(cfg.d_model, dtype, device),
        "ffn": glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> dict:
    """Random parameters in ``cfg.activation_dtype`` on ``device``, drawn
    from ``gen`` on its own device (pass a CUDA generator for a full-size
    model on the card). Weights are random: configurations are shapes."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": [_block_init(gen, cfg, dtype, dev)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                    dtype=dtype, device=dev)
    return params


def _block_apply(p, cfg: ModelConfig, x, kernel_mode):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "rff":
        a = rff_mod.rff_attn_apply(p["attn"], cfg, h, kernel_mode=kernel_mode)
    else:
        a = attn_mod.gqa_apply(p["attn"], cfg, h, kernel_mode=kernel_mode)
    x = x + a
    return x + glu_mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def apply_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                kernel_mode: str = "auto") -> torch.Tensor:
    """The layer stack over hidden states x (B, S, d)."""
    check_supported(cfg)
    for layer_p in params["blocks"]:
        x = _block_apply(layer_p, cfg, x, kernel_mode)
    return x


def _mask_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """-1e30 on the inert padded vocab slots (the unpadded function)."""
    vp = cfg.padded_vocab
    if vp == cfg.vocab_size:
        return logits
    valid = torch.arange(vp, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits,
                       torch.full_like(logits, -1e30))


def head_logits(params: dict, cfg: ModelConfig, h: torch.Tensor):
    """Final norm, the (tied or untied) head and the vocab mask."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].T
    else:
        logits = dense(params["head"], h)
    return _mask_vocab(cfg, logits)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            kernel_mode: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) int -> logits (B, S,
    V_padded). (``repro``'s ``embeds`` input serves its frontend archs,
    which are not ported.)"""
    x = apply_stack(params, cfg, params["embed"]["table"][tokens],
                    kernel_mode=kernel_mode)
    return head_logits(params, cfg, x)


def _block_state_init(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.attention == "rff":
        return rff_mod.rff_state_init(cfg, batch, device=device)
    dh = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.num_kv_heads, dh)
    dtype = cfg.activation_dtype
    return attn_mod.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device),
                            pos=0)


def decode_state_init(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """Per-layer decode state: ``{"stack": [one per layer]}``, an
    :class:`RFFState` (fixed size) or a :class:`KVCache` of ``max_len``."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"stack": [_block_state_init(cfg, batch, max_len, dev)
                      for _ in range(cfg.num_layers)]}


def _block_decode(p, cfg: ModelConfig, x, state, kernel_mode):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "rff":
        out, new_state = rff_mod.rff_attn_decode(p["attn"], cfg, h, state,
                                                 kernel_mode=kernel_mode)
    else:
        out, new_state = attn_mod.gqa_decode(p["attn"], cfg, h, state)
    x = x + out
    return x + glu_mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps)), new_state


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                token: torch.Tensor, *, kernel_mode: str = "auto"):
    """One serving step: token (B,) int -> (logits (B, V_padded), the new
    state). A KV cache is written in place (``attention.gqa_decode``)."""
    x = params["embed"]["table"][token[:, None]]
    new_stack = []
    for layer_p, layer_s in zip(params["blocks"], state["stack"]):
        x, s = _block_decode(layer_p, cfg, x, layer_s, kernel_mode)
        new_stack.append(s)
    return head_logits(params, cfg, x)[:, 0], {"stack": new_stack}
