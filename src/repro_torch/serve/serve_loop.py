"""Batched autoregressive serving loop.

Counterpart of ``repro/serve/serve_loop.py``: the prompt is fed token by
token through ``models.decode_step`` (state warm-up), then ``generate``
decodes greedily or samples at a temperature from an explicit
``torch.Generator``. The decode state is whatever the arch provides (a KV
cache, an MLA latent cache, the fixed-size RFF or mamba2 state, the
hybrid's RG-LRU states and ring cache) and threads through ``decode_step``
the same way. ``repro`` runs the loop as a ``lax.scan`` under one jit; here
it is a Python loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_state_init, decode_step

__all__ = ["prefill_tokens", "generate", "path_logits", "cache_grows"]


def prefill_tokens(params: dict, cfg: ModelConfig, state, tokens, *,
                   kernel_mode: str = "auto"):
    """Feed a prompt (B, P) token by token through the decode path.
    Returns (state, the last position's logits (B, V))."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(params, cfg, state, tokens[:, t],
                                    kernel_mode=kernel_mode)
    return state, logits


def cache_grows(cfg: ModelConfig) -> bool:
    """Whether the decode state is a cache of ``max_len`` positions (a GQA
    KV cache or an MLA latent cache). The RFF and mamba2 states are fixed
    in size, and the hybrid's ring cache wraps at its window."""
    return cfg.mixer == "attention" and cfg.attention in ("gqa", "mla")


def _decode(params, cfg, prompt, steps, max_len, kernel_mode, pick):
    """Prefill ``prompt``, then ``steps`` tokens chosen by ``pick(i,
    logits)``. Returns (tokens (B, steps), the logits each token was chosen
    from (B, steps, V))."""
    if cache_grows(cfg) and prompt.shape[1] + steps - 1 > max_len:
        raise ValueError(
            f"prompt {prompt.shape[1]} + {steps} steps exceeds the "
            f"{cfg.attention} cache's max_len {max_len}"
        )
    state = decode_state_init(cfg, prompt.shape[0], max_len,
                              device=prompt.device)
    state, logits = prefill_tokens(params, cfg, state, prompt,
                                   kernel_mode=kernel_mode)
    toks, seen = [], []
    for i in range(steps):
        tok = pick(i, logits)
        toks.append(tok)
        seen.append(logits)
        if i + 1 < steps:  # the logits after the last token are not used
            logits, state = decode_step(params, cfg, state, tok,
                                        kernel_mode=kernel_mode)
    return torch.stack(toks, dim=1), torch.stack(seen, dim=1)


def generate(params: dict, cfg: ModelConfig, prompt: torch.Tensor, *,
             steps: int = 32, max_len: int = 1024, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             kernel_mode: str = "auto") -> torch.Tensor:
    """Generate ``steps`` tokens after ``prompt`` (B, P) -> (B, steps)
    int32 tokens, as ``repro`` returns them.

    Greedy at ``temperature <= 0``; else each token is drawn from
    ``softmax(logits / temperature)`` with ``generator`` (on the logits'
    device; ``repro`` draws with a JAX key, so sampled tokens differ
    between the two).
    """
    def pick(_, logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    toks = _decode(params, cfg, prompt, steps, max_len, kernel_mode, pick)[0]
    return toks.to(torch.int32)


def path_logits(params: dict, cfg: ModelConfig, prompt: torch.Tensor,
                tokens: torch.Tensor, *, max_len: int = 1024,
                kernel_mode: str = "auto") -> torch.Tensor:
    """The logits ``generate`` would choose each of ``tokens`` (B, steps)
    from, had it produced them (teacher forcing): (B, steps, V). Compares
    two runs along one token path."""
    _, logits = _decode(params, cfg, prompt, tokens.shape[1], max_len,
                        kernel_mode, lambda i, _: tokens[:, i])
    return logits
