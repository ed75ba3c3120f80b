"""Gradient compression: int8 symmetric quantization with error feedback.

Counterpart of ``repro/optim/compression.py``: the quantization residual
is carried and added back next round, so the compression error stays
O(1) instead of growing with the rounds. Each leaf's scale is
``max(max|v|, 1e-12) / 127`` in f32 and its codes ``round(v / scale)``
(half to even, as ``jnp.round``) clipped to [-127, 127]: ``repro``'s codes
and scales bit for bit. ``core/distributed.py`` keeps its own combine.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten

__all__ = ["CompressionState", "init_state", "compress_tree",
           "decompress_tree"]


class CompressionState(NamedTuple):
    residual: Any  # tree like grads, f32


def init_state(grads: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def _q(v: torch.Tensor):
    scale = torch.clamp(torch.max(torch.abs(v)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_tree(grads: Any, state: CompressionState):
    """Returns (int8 tree, scale tree, the new state with residuals)."""
    msg = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    qs = [_q(v) for v in leaves(msg)]
    q_tree = unflatten(msg, [q for q, _ in qs])
    s_tree = unflatten(msg, [s for _, s in qs])
    deq = decompress_tree(q_tree, s_tree)
    return q_tree, s_tree, CompressionState(
        residual=tree_map(lambda m, d: m - d, msg, deq))


def decompress_tree(q_tree: Any, s_tree: Any) -> Any:
    return tree_map(lambda q, s: q.float() * s, q_tree, s_tree)
