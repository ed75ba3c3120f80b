"""The stand-in family's plain reference: the decoder's full forward pass
in float32 with TF32 off, no cache and no kernels, written from the
qwen2 block (arXiv:2407.10671): per layer ``x += W_o attn(RoPE(W_q h +
b_q), RoPE(W_k h + b_k), W_v h + b_v)`` with ``h = RMSNorm(x)``, causal
softmax over keys shared by each group of query heads, then ``x +=
W_d (silu(W_g h) * W_i h)``; the logits are ``RMSNorm(x) E^T`` (tied
embeddings). RoPE rotates the two halves of a head by ``pos *
theta^(-2i / dh)``. It reads the benchmark's weights by name
(``families/lm-standin.py``)."""
from __future__ import annotations

import torch

from portbench.reference.common import exact_matmul

__all__ = ["forward"]


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (B, S, H, dh), positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def forward(cfg: dict, w: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), float32."""
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h, kv, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    b, s = tokens.shape
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).tril()
    with exact_matmul():
        x = w["embed"][tokens]
        for layer in range(cfg["num_layers"]):
            p = {k.split(".", 1)[1]: v for k, v in w.items()
                 if k.startswith(f"{layer}.")}
            a = _norm(x, p["ln1"], eps)
            q = _rope((a @ p["wq"] + p["bq"]).view(b, s, h, dh), theta)
            k = _rope((a @ p["wk"] + p["bk"]).view(b, s, kv, dh), theta)
            v = (a @ p["wv"] + p["bv"]).view(b, s, kv, dh)
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
            score = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
            score = score.masked_fill(~causal, float("-inf"))
            att = torch.einsum("bhqk,bkhd->bqhd", score.softmax(-1), v)
            x = x + att.reshape(b, s, h * dh) @ p["wo"]
            f = _norm(x, p["ln2"], eps)
            x = x + (torch.nn.functional.silu(f @ p["wg"]) * (f @ p["wi"])) \
                @ p["wd"]
        return _norm(x, w["norm"], eps) @ w["embed"].T
