"""Mamba-2 SSD (state-space duality) mixer, chunked.

Counterpart of ``repro/models/ssm.py``. Per head: scalar decay ``a_t =
exp(dt_t * A)`` (A < 0 learned), state ``h in R^{dh x N}``:

    h_t = a_t h_{t-1} + dt_t x_t B_t^T,      y_t = h_t C_t + D x_t

Within a chunk, with L = cumsum(log a),

    M[t,s] = exp(L_t - L_s) (C_t . B_s) dt_s   (s <= t),
    y_intra = M x,  y_inter[t] = exp(L_t) (C_t . h_prev)

are matmuls; only the chunks are sequential (``repro``'s ``lax.scan``
is a loop here). The scan works in f32, and the decode state keeps the
conv tail in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, dense_init, normal

__all__ = ["mamba2_init", "mamba2_apply", "mamba2_decode", "Mamba2State",
           "mamba2_state_init"]


class Mamba2State(NamedTuple):
    h: torch.Tensor  # (B, H, dh, N) SSM state, f32
    conv: torch.Tensor  # (B, W-1, conv_dim) depthwise-conv tail, f32
    pos: int  # tokens consumed


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, nheads, conv_dim


def mamba2_init(gen, cfg: ModelConfig, dtype=torch.float32,
                device="cuda") -> dict:
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    n = cfg.ssm_state
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    # in_proj emits [z (gate), x, B, C, dt] concatenated.
    return {
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * n + nheads, dtype=dtype,
                           device=dev),
        "conv_w": normal(gen, (conv_dim, cfg.conv_width), 0.1, dtype, dev),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "d_skip": torch.ones(nheads, **f32),
        "dt_bias": torch.zeros(nheads, **f32),
        "norm_scale": torch.ones(d_inner, dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_inner, d, dtype=dtype, device=dev),
    }


def _split_in(cfg: ModelConfig, proj):
    d_inner, _, _ = _dims(cfg)
    n = cfg.ssm_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt  # gate, conv input, per-head dt


def _causal_conv(xbc, w, b, tail=None):
    """Depthwise causal conv over time. xbc: (B, S, C); w: (C, W); tail
    (B, W-1, C) or zeros. Returns (silu(conv + b), the new tail)."""
    width = w.shape[1]
    if tail is None:
        tail = xbc.new_zeros(xbc.shape[0], width - 1, xbc.shape[2])
    xp = torch.cat([tail, xbc], dim=1)
    s = xbc.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[:, i]
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return F.silu(out + b), new_tail


def _ssd_chunked(x, b_in, c_in, dt, a_log, chunk: int):
    """Chunked SSD scan in f32.

    x: (B, S, H, dh); b_in/c_in: (B, S, N); dt: (B, S, H) (softplus'd).
    Returns y (B, S, H, dh) f32 and the final state (B, H, dh, N).
    """
    bsz, s, h, dh = x.shape
    n = b_in.shape[-1]
    c = min(chunk, s)
    assert s % c == 0, f"seq {s} % chunk {c} != 0"
    a = -torch.exp(a_log)  # (H,) negative decay rates
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    h_state = x.new_zeros(bsz, h, dh, n, dtype=torch.float32)
    ys = []
    for c0 in range(0, s, c):
        xk = x[:, c0:c0 + c].float()
        bk = b_in[:, c0:c0 + c].float()
        ck = c_in[:, c0:c0 + c].float()
        dtk = dt[:, c0:c0 + c].float()
        lcum = torch.cumsum(dtk * a, dim=1)  # (B, c, H), L_t inclusive
        ldiff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, c, c, H)
        ldiff = torch.where(mask[None, :, :, None], ldiff,
                            torch.full_like(ldiff, -torch.inf))
        cb = torch.einsum("btn,bsn->bts", ck, bk)
        m = torch.exp(ldiff) * (cb[..., None] * dtk[:, None, :, :])
        y = torch.einsum("btsh,bshd->bthd", m, xk)  # intra-chunk
        y = y + torch.einsum("bth,btn,bhdn->bthd", torch.exp(lcum), ck,
                             h_state)  # inter-chunk
        total = lcum[:, -1:, :]  # (B, 1, H)
        w_s = torch.exp(total - lcum) * dtk
        h_new = torch.einsum("bsh,bshd,bsn->bhdn", w_s, xk, bk)
        h_state = h_state * torch.exp(total[:, 0])[:, :, None, None] + h_new
        ys.append(y)
    return torch.cat(ys, dim=1), h_state


def _gated_norm(p, y, z, dtype):
    """RMSNorm(y * silu(z)) with mamba2's scale, in ``dtype``."""
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + 1e-5)).to(dtype) * p["norm_scale"]


def mamba2_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block. x: (B, S, d)."""
    bsz, s, _ = x.shape
    d_inner, nheads, _ = _dims(cfg)
    n = cfg.ssm_state
    z, xbc, dt = _split_in(cfg, dense(p["w_in"], x))
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, b_in, c_in = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                      xbc[..., d_inner + n:])
    xh = xs.reshape(bsz, s, nheads, cfg.ssm_head_dim)
    dt_sp = F.softplus(dt.float() + p["dt_bias"])
    y, _ = _ssd_chunked(xh, b_in, c_in, dt_sp, p["a_log"], cfg.ssm_chunk)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    return dense(p["w_out"], _gated_norm(p, y, z, x.dtype))


def mamba2_state_init(cfg: ModelConfig, batch: int, *,
                      device="cuda") -> Mamba2State:
    _, nheads, conv_dim = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return Mamba2State(
        h=torch.zeros(batch, nheads, cfg.ssm_head_dim, cfg.ssm_state, **f32),
        conv=torch.zeros(batch, cfg.conv_width - 1, conv_dim, **f32),
        pos=0,
    )


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Mamba2State):
    """One-token SSD decode, O(H dh N). x: (B, 1, d). Returns (out, the
    new state)."""
    bsz = x.shape[0]
    d_inner, nheads, _ = _dims(cfg)
    n = cfg.ssm_state
    z, xbc, dt = _split_in(cfg, dense(p["w_in"], x))
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 tail=state.conv.to(xbc.dtype))
    xbc = xbc[:, 0]
    xs, b_in, c_in = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                      xbc[..., d_inner + n:])
    xh = xs.reshape(bsz, nheads, cfg.ssm_head_dim).float()
    dt_sp = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt_sp * -torch.exp(p["a_log"]))
    h_new = state.h * decay[:, :, None, None] + torch.einsum(
        "bh,bhd,bn->bhdn", dt_sp, xh, b_in.float())
    y = torch.einsum("bhdn,bn->bhd", h_new, c_in.float())
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    out = dense(p["w_out"], _gated_norm(p, y, z, x.dtype))
    return out, Mamba2State(h=h_new, conv=new_tail.float(),
                            pos=state.pos + 1)
