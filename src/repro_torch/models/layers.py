"""Functional building blocks (parameter dicts + plain apply functions).

Counterpart of ``repro/models/layers.py``: parameters are nested dicts of
tensors, inits draw from an explicit ``torch.Generator`` (on its own
device, then moved to ``device``), apply functions are pure.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

__all__ = [
    "normal",
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "embed_init",
    "glu_mlp_init",
    "glu_mlp",
    "rope_freqs",
    "apply_rope",
]


def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``scale * N(0, 1)`` drawn in f32 on the generator's device, scaled
    in place, then cast and moved to ``device`` (a CUDA generator keeps a
    full-size init on the card; its peak is one f32 copy of the tensor)."""
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.mul_(scale).to(device=device, dtype=dtype)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, scale=None, device="cuda") -> dict:
    device = resolve_device(device)
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=resolve_device(device))}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32 and cast back to ``x``'s type."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32,
               device="cuda") -> dict:
    return {"table": normal(gen, (vocab, d), d ** -0.5, dtype,
                            resolve_device(device))}


def glu_mlp_init(gen, d: int, d_ff: int, dtype=torch.float32,
                 device="cuda") -> dict:
    device = resolve_device(device)
    return {
        "wi": dense_init(gen, d, d_ff, dtype=dtype, device=device),
        "wg": dense_init(gen, d, d_ff, dtype=dtype, device=device),
        "wo": dense_init(gen, d_ff, d, dtype=dtype, device=device),
    }


def glu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return dense(p["wo"], F.silu(dense(p["wg"], x)) * dense(p["wi"], x))


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10_000.0):
    """Rotary cos/sin tables for integer positions ``(...,)`` -> ``(...,
    hd/2)``, in f32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = float(theta) ** exponent  # no host-to-device copy of theta
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the two halves (not interleaved pairs). x: (..., S, H, hd);
    cos/sin: (..., S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
