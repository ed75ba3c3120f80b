"""Deterministic, seekable synthetic LM data.

Counterpart of ``repro/data/lm_data.py``. Every batch is a function of
``(seed, step)`` alone: its noise is drawn from a ``torch.Generator``
seeded from the pair, so there is no iterator state to checkpoint, and a
resume at step n (on any number of devices) reads the same batches.

The tokens are an order-1 Markov chain over the vocab with occasional
jumps (learnable structure, so the training loss falls): ``t_{n+1} =
(t_n * mult + 12345) % vocab``, ``mult = 6364136223846793005 % vocab``,
replaced by a uniform jump with probability 0.1. The chain is computed on
int32 tokens, wrapping as ``repro``'s does (at vocab 151936 the products
pass 2^31), with the divisor's sign (``torch.remainder``, ``jnp``'s %).
The draws differ from ``repro``'s (``jax.random`` is not reproduced);
:func:`markov_batch_from_noise` maps given draws to ``repro``'s tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["batch_at_step", "markov_batch", "markov_batch_from_noise"]

_JUMP_P = 0.1


def batch_at_step(seed: int, step: int, *, global_batch: int, seq_len: int,
                  vocab: int, device="cuda") -> torch.Tensor:
    """(B, S) int32 tokens, a function of ``(seed, step)`` alone, on
    ``device`` (drawn and chained on the CPU, so every device reads the
    same tokens)."""
    dev = resolve_device(device)
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(mixed[0]))
    return markov_batch(gen, global_batch, seq_len, vocab).to(dev)


def markov_batch(gen: torch.Generator, batch: int, seq_len: int,
                 vocab: int) -> torch.Tensor:
    """(B, S) int32 tokens from draws of ``gen`` on its own device: start
    tokens, jump flags and jump targets."""
    kw = dict(generator=gen, device=gen.device)
    start = torch.randint(0, vocab, (batch,), dtype=torch.int32, **kw)
    flips = torch.rand((batch, seq_len), **kw) < _JUMP_P
    jumps = torch.randint(0, vocab, (batch, seq_len), dtype=torch.int32,
                          **kw)
    return markov_batch_from_noise(start, flips, jumps, vocab)


def _cpu(a, dtype) -> torch.Tensor:
    """A tensor or a numpy array as a CPU tensor of ``dtype``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device="cpu", dtype=dtype)


def markov_batch_from_noise(start, flips, jumps, vocab: int) -> torch.Tensor:
    """The chain from given draws: start (B,) tokens, flips (B, S) bool,
    jumps (B, S) tokens -> (B, S) int32, ``repro``'s tokens for
    ``repro``'s draws (numpy arrays or tensors)."""
    tok, flips, jumps = (_cpu(a, dtype) for a, dtype in (
        (start, torch.int32), (flips, torch.bool), (jumps, torch.int32)))
    mult = 6364136223846793005 % vocab or 1
    out = []
    for t in range(flips.shape[1]):
        nxt = torch.remainder(tok * mult + 12345, vocab)
        tok = torch.where(flips[:, t], jumps[:, t], nxt)
        out.append(tok)
    if not out:
        return jumps.new_empty(flips.shape)
    return torch.stack(out, dim=1)
