"""RFF linear attention: the paper's fixed-size-state technique as a layer.

Counterpart of ``repro/models/rff_attention.py``. Softmax attention is a
kernel machine whose dictionary (the KV cache) grows with the context; an
explicit random-feature map gives each head a fixed-size state instead:

    S_t = sum_{s<=t} phi(k_s) v_s^T   (D x dv),   z_t = sum_{s<=t} phi(k_s).

The full sequence runs through the chunked linear-attention kernel
(``ops.rff_attention``); decode is the fused decode-block kernel
(``ops.rff_attention_decode_block``): O(D dv) per token whatever the
context length. Feature maps: "prf" (positive random features of the
softmax kernel, the default) or "trig" (``scale * cos(x @ omega +
bias)``, any :class:`repro_torch.features.TrigFeatures`, via
``feature_map=``). The feature buffers are fixed, like the paper's Omega.
"""
from __future__ import annotations

import functools

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.rff import RFF, positive_random_features, sample_prf
from repro_torch.features.base import (
    TrigFeatures,
    as_trig,
    trig_features,
    uniform_trig_scale,
)
from repro_torch.kernels import ops
from repro_torch.models.attention import (
    apply_head_mask,
    head_mask,
    head_out,
    head_out_init,
    head_proj,
    head_proj_init,
)
from repro_torch.models.layers import apply_rope, rope_freqs

__all__ = [
    "RFFState",
    "rff_attn_init",
    "rff_attn_apply",
    "rff_state_init",
    "rff_attn_decode_block",
    "rff_attn_decode",
]


class RFFState(NamedTuple):
    s: torch.Tensor  # (B, H, D, dv) running sum phi(k) v^T
    z: torch.Tensor  # (B, H, D) running sum phi(k)
    pos: int  # tokens consumed


def rff_attn_init(gen, cfg: ModelConfig, dtype=torch.float32,
                  feature_map: Optional[TrigFeatures] = None,
                  device="cuda") -> dict:
    """Projections and the fixed feature buffers (per-layer Omega).

    ``feature_map`` (a :class:`FeatureMap` or :class:`TrigFeatures` of a
    trig family, shape (head_dim, rff_num_features)) replaces the default orthogonal PRF draw; the prf
    path reads only ``omega``, so trig families pair with
    ``feature_kind="trig"``.
    """
    d, h = cfg.d_model, cfg.padded_heads
    dh = cfg.resolved_head_dim
    dfeat = cfg.rff_num_features
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": head_proj_init(gen, d, h, dh, **kw),
        "wk": head_proj_init(gen, d, h, dh, **kw),
        "wv": head_proj_init(gen, d, h, dh, **kw),
        "wo": head_out_init(gen, h, dh, d, **kw),
    }
    if feature_map is None:
        feat = sample_prf(gen, dh, dfeat, device=device)
        omega, bias = feat.omega, feat.bias
        scale = uniform_trig_scale(dfeat, torch.float32, device)
    else:
        if feature_map.input_dim != dh or feature_map.num_features != dfeat:
            raise ValueError(
                f"feature_map is ({feature_map.input_dim}, "
                f"{feature_map.num_features}); cfg wants head_dim={dh}, "
                f"rff_num_features={dfeat}"
            )
        omega, bias, scale = (t.to(device=device, dtype=torch.float32)
                              for t in as_trig(feature_map))
    p.update(omega=omega, bias=bias, scale=scale)
    return p


def _trig_buffers(p: dict) -> TrigFeatures:
    """The fixed feature buffers, cut from the gradient (``repro``'s
    ``stop_gradient``): they stay leaves of the params, whose gradient is
    zero and which AdamW still decays."""
    return TrigFeatures(omega=p["omega"].detach().float(),
                        bias=p["bias"].detach().float(),
                        scale=p["scale"].detach().float())


def _feature(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    tf = _trig_buffers(p)
    x32 = x.float()
    if kind == "trig":
        return trig_features(tf, x32)
    return positive_random_features(RFF(omega=tf.omega, bias=tf.bias), x32)


def _project(p, cfg: ModelConfig, x, positions):
    dh = cfg.resolved_head_dim
    q = head_proj(p["wq"], x)  # (B, S, H, dh)
    k = head_proj(p["wk"], x)
    v = head_proj(p["wv"], x)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    # RoPE before the feature map: a kernel of the rotated vectors.
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, e) -> (B H, S, e), f32, contiguous."""
    b, s, h, e = t.shape
    return t.float().transpose(1, 2).reshape(b * h, s, e).contiguous()


def _linear_attention(phi_q, phi_k, v, **kw):
    """Kernel 10 (or its plain version) on (B, S, H, e) tensors through
    its (B H, S, e) layout; (B, S, H, dh) out."""
    b, s, h, dh = v.shape
    out = ops.rff_attention(_heads_first(phi_q), _heads_first(phi_k),
                            _heads_first(v), **kw)
    return out.reshape(b, h, s, dh).transpose(1, 2)


def rff_attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                   feature_kind: str = "prf", kernel_mode: str = "auto"):
    """Full-sequence causal RFF linear attention. x: (B, S, d)."""
    b, s, _ = x.shape
    h, dh = cfg.padded_heads, cfg.resolved_head_dim
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, cfg, x, positions)
    scale = dh ** -0.25  # split the 1/sqrt(dh) between q and k
    phi_q = _feature(p, q * scale, feature_kind)  # (B, S, H, D)
    phi_k = _feature(p, k * scale, feature_kind)
    run = functools.partial(_linear_attention, mode=kernel_mode,
                            chunk=min(cfg.rff_chunk, s),
                            normalize=feature_kind == "prf")
    if ops.use_kernel(kernel_mode, x):  # DTensors: batch and heads are rows
        out = ops.on_local_shards(run, (phi_q, phi_k, v),
                                  (((0, 2), (1, 3)),) * 3)
    else:
        out = run(phi_q, phi_k, v)
    out = apply_head_mask(out, head_mask(cfg))
    return head_out(p["wo"], out.to(x.dtype))


def rff_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> RFFState:
    device = resolve_device(device)
    h, dh, dfeat = (cfg.padded_heads, cfg.resolved_head_dim,
                    cfg.rff_num_features)
    return RFFState(
        s=torch.zeros(batch, h, dfeat, dh, dtype=dtype, device=device),
        z=torch.zeros(batch, h, dfeat, dtype=dtype, device=device),
        pos=0,
    )


def _decode_block(s_state, z_state, q, k, v, w, b, s, **kw):
    """Kernel 9 (or its plain version) on the (B, H, D, dv) state and (B,
    T, H, e) tokens through its (B H, ...) layout: (out (B, T, H, dh), S'
    (B, H, D, dv), z' (B, H, D))."""
    bsz, heads, dfeat, dv = s_state.shape
    t = q.shape[1]
    out, s_new, z_new = ops.rff_attention_decode_block(
        s_state.reshape(bsz * heads, dfeat, dv),
        z_state.reshape(bsz * heads, dfeat),
        _heads_first(q), _heads_first(k), _heads_first(v), w, b, s, **kw)
    return (out.reshape(bsz, heads, t, dv).transpose(1, 2),
            s_new.reshape(bsz, heads, dfeat, dv),
            z_new.reshape(bsz, heads, dfeat))


def rff_attn_decode_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          state: RFFState, *, feature_kind: str = "prf",
                          kernel_mode: str = "auto",
                          block_t: Optional[int] = None,
                          precision: Optional[str] = None):
    """Decode a (B, T, d) block of tokens from the fixed-size state.

    The tokens enter the fused decode kernel pre-projected; it featurizes
    them and runs the T sequential ticks against the head's state, which
    it reads and writes once per launch. ``precision="bf16"`` runs the
    featurize GEMM under the read-path contract (bf16 operands, f32
    accumulation, f32 state). Returns (out (B, T, d), the new state).
    """
    b, t = x.shape[0], x.shape[1]
    h, dh = cfg.padded_heads, cfg.resolved_head_dim
    positions = (state.pos
                 + torch.arange(t, device=x.device)[None, :].expand(b, t))
    q, k, v = _project(p, cfg, x, positions)
    scale = dh ** -0.25
    tf = _trig_buffers(p)
    dfeat = tf.num_features
    run = functools.partial(
        _decode_block, feature_kind=feature_kind, mode=kernel_mode,
        block_t=block_t, normalize=feature_kind == "prf",
        precision=precision)
    args = (state.s.float(), state.z.float(), q * scale, k * scale, v)
    shared = (tf.omega, tf.bias, tf.scale if feature_kind == "trig" else None)
    if ops.use_kernel(kernel_mode, x):  # DTensors: batch and heads are rows
        seq = ((0, 2), (1, 3))
        out, s_new, z_new = ops.on_local_shards(
            run, args, (((0, 1), (2, 3)), ((0, 1), (2,)), seq, seq, seq),
            shared=shared, outs=(2, 0, 1))
    else:
        out, s_new, z_new = run(*args, *shared)
    new_state = RFFState(s=s_new.to(state.s.dtype), z=z_new.to(state.z.dtype),
                         pos=state.pos + t)
    out = out.to(x.dtype)
    out = apply_head_mask(out, head_mask(cfg))
    return head_out(p["wo"], out), new_state


def rff_attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    state: RFFState, *, feature_kind: str = "prf",
                    kernel_mode: str = "auto",
                    precision: Optional[str] = None):
    """One-token decode from the fixed-size state (the T = 1 block).
    x: (B, 1, d)."""
    return rff_attn_decode_block(p, cfg, x, state, feature_kind=feature_kind,
                                 kernel_mode=kernel_mode, precision=precision)
