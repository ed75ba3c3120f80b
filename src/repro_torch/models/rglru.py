"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro/models/rglru.py``: the Real-Gated Linear Recurrent
Unit with block-diagonal per-head gates,

    r_t = sigmoid(blockdiag(W_r) xw_t)      (recurrence gate)
    i_t = sigmoid(blockdiag(W_i) xw_t)      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (per-channel decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * xw_t)

on channels organized as (heads, head_dim); the padded heads are masked
before the output projection. The block: conv1d then the RG-LRU on one
branch, a gelu gate (tanh approximation, ``jax.nn.gelu``'s default) on the
other, their product, then the out-projection.

Within a chunk the recurrence is composed by a log-depth inclusive scan
with ``repro``'s combine, ``(a1, u1), (a2, u2) -> (a1 a2, u1 a2 + u2)``;
``repro``'s ``associative_scan`` composes in another order, so the two
agree to rounding (ROADMAP §3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    apply_head_mask,
    head_mask,
    head_out,
    head_out_init,
    head_proj,
    head_proj_init,
)
from repro_torch.models.layers import normal

__all__ = ["rglru_init", "rglru_apply", "rglru_decode", "RGLRUState",
           "rglru_state_init"]

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, Hp, hd) recurrent state, f32
    conv: torch.Tensor  # (B, conv_width-1, Hp, hd) conv tail, f32
    pos: int  # tokens consumed


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    """(padded head count, lru head dim)."""
    w = cfg.lru_width or cfg.d_model
    return cfg.padded_heads, w // cfg.num_heads


def rglru_init(gen, cfg: ModelConfig, dtype=torch.float32,
               device="cuda") -> dict:
    d = cfg.d_model
    hp, hd = _dims(cfg)
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    lam = torch.linspace(0.3, 1.5, hp * hd, dtype=torch.float32, device=dev)
    return {
        "w_x": head_proj_init(gen, d, hp, hd, **kw),
        "w_gate": head_proj_init(gen, d, hp, hd, **kw),
        "conv_w": normal(gen, (hp, hd, cfg.conv_width), 0.1, dtype, dev),
        "conv_b": torch.zeros(hp, hd, **kw),
        # block-diagonal gates: one (hd, hd) block per head
        "w_r": normal(gen, (hp, hd, hd), hd ** -0.5, dtype, dev),
        "w_i": normal(gen, (hp, hd, hd), hd ** -0.5, dtype, dev),
        # Lambda so the decays start in a useful range
        "lam": torch.log(torch.expm1(lam)).reshape(hp, hd),
        "w_out": head_out_init(gen, hp, hd, d, **kw),
    }


def _causal_conv(u, w, b, tail=None):
    """Depthwise causal conv over time. u: (B, S, Hp, hd); w: (Hp, hd,
    W); tail (B, W-1, Hp, hd) or zeros. Returns (conv + b, the new
    tail)."""
    width = w.shape[-1]
    if tail is None:
        tail = u.new_zeros((u.shape[0], width - 1) + tuple(u.shape[2:]))
    up = torch.cat([tail, u], dim=1)
    s = u.shape[1]
    out = 0
    for i in range(width):
        out = out + up[:, i:i + s] * w[None, None, :, :, i]
    return out + b, up[:, -(width - 1):]


def _scan_chunks(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + u_t along axis 2 from h = 0
    (Hillis-Steele: log2(c) combines on the whole tensor). Returns the
    cumulative (a, u): h_t = a_cum_t h_0 + u_cum_t."""
    c = a.shape[2]
    off = 1
    while off < c:
        a_prev, u_prev = a[:, :, :-off], u[:, :, :-off]
        a_cur, u_cur = a[:, :, off:], u[:, :, off:]
        u = torch.cat([u[:, :, :off], u_prev * a_cur + u_cur], dim=2)
        a = torch.cat([a[:, :, :off], a_prev * a_cur], dim=2)
        off *= 2
    return a, u


def _lru_scan(u: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
              chunk: int):
    """Diagonal recurrence h_t = a_t h_{t-1} + u_t over chunks of
    ``chunk``. u, a: (B, S, Hp, hd); h0: (B, Hp, hd). Returns (h for
    every t, the last h)."""
    bsz, s = u.shape[:2]
    rest = tuple(u.shape[2:])
    c = min(chunk, s)
    assert s % c == 0
    nc = s // c
    a_cum, u_cum = _scan_chunks(a.reshape((bsz, nc, c) + rest),
                                u.reshape((bsz, nc, c) + rest))
    h, hs = h0, []
    for i in range(nc):
        hc = a_cum[:, i] * h[:, None] + u_cum[:, i]
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1), h


def _gates(p, xw):
    """Block-diagonal gates. xw: (..., Hp, hd). Returns (a, the input
    scale beta * i), f32."""
    r_pre = torch.einsum("...he,hef->...hf", xw, p["w_r"])
    i_pre = torch.einsum("...he,hef->...hf", xw, p["w_i"])
    r = torch.sigmoid(r_pre.float())
    i = torch.sigmoid(i_pre.float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i


def rglru_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                chunk: int = 256) -> torch.Tensor:
    """Full-sequence recurrent block. x: (B, S, d)."""
    bsz = x.shape[0]
    hp, hd = _dims(cfg)
    gate = F.gelu(head_proj(p["w_gate"], x), approximate="tanh")
    xw, _ = _causal_conv(head_proj(p["w_x"], x), p["conv_w"], p["conv_b"])
    a, scaled_in = _gates(p, xw)
    u = scaled_in * xw.float()
    h0 = x.new_zeros(bsz, hp, hd, dtype=torch.float32)
    hs, _ = _lru_scan(u, a, h0, chunk)
    y = hs.to(x.dtype) * gate
    return head_out(p["w_out"], apply_head_mask(y, head_mask(cfg)))


def rglru_state_init(cfg: ModelConfig, batch: int, *,
                     device="cuda") -> RGLRUState:
    hp, hd = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return RGLRUState(h=torch.zeros(batch, hp, hd, **f32),
                      conv=torch.zeros(batch, cfg.conv_width - 1, hp, hd,
                                       **f32),
                      pos=0)


def rglru_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: RGLRUState):
    """One-token decode, O(W) state update. x: (B, 1, d). Returns (out,
    the new state)."""
    gate = F.gelu(head_proj(p["w_gate"], x), approximate="tanh")
    xw = head_proj(p["w_x"], x)
    xw, new_tail = _causal_conv(xw, p["conv_w"], p["conv_b"],
                                tail=state.conv.to(xw.dtype))
    a, scaled_in = _gates(p, xw[:, 0])
    h = a * state.h + scaled_in * xw[:, 0].float()
    y = h[:, None].to(x.dtype) * gate
    out = head_out(p["w_out"], apply_head_mask(y, head_mask(cfg)))
    return out, RGLRUState(h=h, conv=new_tail.float(), pos=state.pos + 1)
