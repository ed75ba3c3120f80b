"""Attention blocks: GQA (optionally windowed) and MLA with the
softmax-attention dispatcher, and cache-based decode.

Counterpart of ``repro/models/attention.py``. Projections are
head-structured, ``(d, H, dh)`` and ``(H, dh, d)``, as in ``repro``. The
dispatcher's CUDA branch takes the place of ``repro``'s TPU branch under
the same conditions and runs the flash kernel
(``kernels/ops.flash_attention``); every other case takes the dense path,
or the blocked online-softmax loop above 8192 keys.
"""
from __future__ import annotations

import functools

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch import resolve_device
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (
    apply_rope,
    dense,
    dense_init,
    normal,
    rope_freqs,
)

__all__ = [
    "KVCache",
    "head_proj_init",
    "head_proj",
    "head_out_init",
    "head_out",
    "repeat_kv",
    "head_mask",
    "apply_head_mask",
    "dense_attention",
    "flash_attention",
    "gqa_init",
    "gqa_apply",
    "gqa_decode",
    "ring_gqa_decode",
    "MLACache",
    "mla_init",
    "mla_apply",
    "mla_decode",
]


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, dh)
    v: torch.Tensor  # (B, S_max, Hkv, dh)
    pos: int  # next write position


def head_proj_init(gen, d: int, heads: int, head_dim: int, *,
                   bias: bool = False, dtype=torch.float32,
                   device="cuda") -> dict:
    device = resolve_device(device)
    p = {"w": normal(gen, (d, heads, head_dim), d ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros(heads, head_dim, dtype=dtype, device=device)
    return p


def head_proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., H, dh). A DTensor weight sharded on d (fsdp,
    ZeRO-3) is gathered on it at use, as fsdp does: the product then splits
    its output by x's rows, never by its (H dh) columns, which a head count
    the mesh does not divide (8 KV heads over 16) could not unflatten."""
    w = p["w"]
    if isinstance(w, DTensor):
        whole = tuple(Replicate() if isinstance(q, (Shard, _StridedShard))
                      and q.dim == 0 else q for q in w.placements)
        if whole != tuple(w.placements):
            w = w.redistribute(w.device_mesh, whole)
    y = torch.einsum("...d,dhe->...he", x, w)
    if "b" in p:
        y = y + p["b"]
    return y


def head_out_init(gen, heads: int, head_dim: int, d: int,
                  dtype=torch.float32, device="cuda") -> dict:
    scale = (heads * head_dim) ** -0.5
    return {"w": normal(gen, (heads, head_dim, d), scale, dtype,
                        resolve_device(device))}


def head_out(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(..., H, dh) -> (..., d)."""
    # One product over (H, dh) flattened with the heads outer: a DTensor
    # sharded by heads flattens so without a redistribution.
    w = p["w"]
    return x.reshape(*x.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, Hkv, dh) -> (B, S, H, dh) by group repetition (GQA)."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


def head_mask(cfg: ModelConfig, dtype=torch.float32,
              device=None) -> Optional[torch.Tensor]:
    """(Hp, 1) constant mask zeroing inert padding heads (``pad_heads_to``),
    or None when no head is padded."""
    hp = cfg.padded_heads
    if hp == cfg.num_heads:
        return None
    m = torch.zeros(hp, 1, dtype=dtype, device=device)
    m[:cfg.num_heads] = 1
    return m


def apply_head_mask(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """x: (..., H, dh) * mask (H, 1)."""
    if mask is None:
        return x
    return x * mask.to(device=x.device, dtype=x.dtype)


def _on_local_rows(fn):
    """``fn(q, k, v, **kw)`` of (B, S, H, e) tensors on DTensors' local
    shards (``ops.on_local_shards``): batch rows and heads are independent
    (heads only where k has q's, not a GQA group's), the sequences and
    head dims are made whole. Its products would
    otherwise flatten sharded batch and head dims, which some DTensor
    versions refuse."""
    @functools.wraps(fn)
    def run(q, k, v, **kw):
        if not isinstance(q, DTensor):
            return fn(q, k, v, **kw)
        # Grouped keys (fewer heads than q) are read whole by every head.
        rows = (0, 2) if k.shape[2] == q.shape[2] else (0,)
        reduced = tuple(d for d in range(4) if d not in rows)
        return ops.on_local_shards(functools.partial(fn, **kw), (q, k, v),
                                   ((rows, reduced),) * 3)
    return run


@_on_local_rows
def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None):
    """Masked softmax attention with the scores materialized once, in f32.
    q (B, Sq, H, dh); k, v (B, Sk, Hkv, dh) -> (B, Sq, H, dv) in q's
    type."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    qg = (q.float() * dh ** -0.5).reshape(b, sq, hkv, group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    keep = _keep_mask(sq, torch.arange(sk, device=q.device), causal=causal,
                      window=window, q_offset=q_offset, kv_len=kv_len)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhv->bqhgv", p, v.float())
    return out.reshape(b, sq, hkv * group, dv).to(q.dtype)


def _keep_mask(sq, kpos, *, causal, window, q_offset, kv_len):
    qpos = q_offset + torch.arange(sq, device=kpos.device)
    keep = torch.ones(sq, kpos.shape[0], dtype=torch.bool, device=kpos.device)
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window:
        keep &= qpos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        keep &= kpos[None, :] < kv_len
    return keep


def _flash_kernel(q, k, v, *, mode):
    """Kernel 11 on (B, S, H, e) tensors through its (B H, S, e) layout."""
    b, s, h, _ = q.shape

    def bh(x):
        return x.transpose(1, 2).reshape(b * h, s, x.shape[-1]).contiguous()

    out = ops.flash_attention(bh(q), bh(k), bh(v), mode=mode)
    return out.reshape(b, h, s, v.shape[-1]).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_k: int = 1024, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    dense_threshold: int = 8192, kernel_mode: str = "auto"):
    """Attention dispatcher. q (B, Sq, H, dh); k, v (B, Sk, Hkv, dh).

    The flash kernel takes the plain full-sequence causal case (kv already
    repeated to H heads, no window, no ``kv_len``, ``q_offset == 0``, equal
    q and k shapes, ``S % min(512, S) == 0``) when ``kernel_mode`` selects
    the kernel for ``q`` (``"auto"`` on a CUDA tensor, or ``"cuda"``);
    ``repro`` takes the same case on a TPU. Otherwise: the dense path up to
    ``dense_threshold`` keys, the blocked online-softmax loop above.
    Returns (B, Sq, H, dv) in q's type.
    """
    if (causal and not window and kv_len is None and q_offset == 0
            and q.shape == k.shape and ops.use_kernel(kernel_mode, q)):
        s = q.shape[1]
        if s % min(512, s) == 0:
            # DTensors: batch and heads are the kernel's rows, so it runs
            # on each rank's local (B, S, H, e) shards.
            return ops.on_local_shards(
                functools.partial(_flash_kernel, mode=kernel_mode),
                (q, k, v), (((0, 2), (1, 3)),) * 3)

    if k.shape[1] <= dense_threshold:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len)
    return _blocked_attention(q, k, v, causal=causal, window=window,
                              block_k=block_k, q_offset=q_offset,
                              kv_len=kv_len)


@_on_local_rows
def _blocked_attention(q, k, v, *, causal, window, block_k, q_offset, kv_len):
    """Online-softmax attention over key blocks of ``block_k`` (long
    forward-only contexts): O(Sq * block_k) scores at a time."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    bk = min(block_k, sk)
    qg = (q.float() * dh ** -0.5).reshape(b, sq, hkv, group, dh)
    m = q.new_full((b, hkv, group, sq), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((b, hkv, group, sq, dv), dtype=torch.float32)
    limit = sk if kv_len is None else kv_len
    for k0 in range(0, sk, bk):
        kb = k[:, k0:k0 + bk].float()
        vb = v[:, k0:k0 + bk].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb)
        keep = _keep_mask(sq, kpos, causal=causal, window=window,
                          q_offset=q_offset, kv_len=limit)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> dict:
    d, hp, hkv = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=resolve_device(device))
    return {
        "wq": head_proj_init(gen, d, hp, dh, bias=cfg.qkv_bias, **kw),
        "wk": head_proj_init(gen, d, hkv, dh, bias=cfg.qkv_bias, **kw),
        "wv": head_proj_init(gen, d, hkv, dh, bias=cfg.qkv_bias, **kw),
        "wo": head_out_init(gen, hp, dh, d, **kw),
    }


def _project_qkv(p, cfg: ModelConfig, x, positions):
    dh = cfg.resolved_head_dim
    q = head_proj(p["wq"], x)  # (B, S, Hp, dh)
    k = head_proj(p["wk"], x)  # (B, S, Hkv, dh)
    v = head_proj(p["wv"], x)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              window: int = 0, block_k: int = 1024,
              kernel_mode: str = "auto"):
    """Full-sequence causal (optionally windowed) GQA. x: (B, S, d)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    k = repeat_kv(k, cfg.padded_heads)
    v = repeat_kv(v, cfg.padded_heads)
    out = flash_attention(q, k, v, causal=True, window=window,
                          block_k=block_k, kernel_mode=kernel_mode)
    return head_out(p["wo"], apply_head_mask(out, head_mask(cfg)))


def _cached_decode(p, cfg: ModelConfig, x, cache: KVCache, slot: int,
                   kv_len: int, window: int = 0):
    """One token against a KV cache stored unrepeated: its key and value
    are written to ``slot`` in place and the query attends to the first
    ``kv_len`` slots; the padded heads are masked before the output
    projection. Returns (out, the cache advanced by one position)."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache.pos, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    out = dense_attention(q, cache.k, cache.v, causal=False, window=window,
                          kv_len=kv_len)
    new_cache = KVCache(k=cache.k, v=cache.v, pos=cache.pos + 1)
    return head_out(p["wo"], apply_head_mask(out, head_mask(cfg))), new_cache


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
               *, window: int = 0):
    """One-token decode against a KV cache stored unrepeated. x: (B, 1, d).

    The new key and value are written into ``cache.k``/``cache.v`` in
    place (``repro`` returns new arrays): a copy per token would move the
    whole (B, S_max, Hkv, dh) cache of every layer. ``window`` masks as
    ``repro``'s does (the query sits at offset 0, so it keeps every valid
    key). Returns (out, the cache advanced by one position)."""
    return _cached_decode(p, cfg, x, cache, cache.pos, cache.pos + 1,
                          window)


def ring_gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: KVCache):
    """Sliding-window decode with a ring-buffer cache of ``win`` slots
    (``repro``'s ``transformer._ring_gqa_decode``): the token goes to slot
    ``pos % win``, in place, and attends to every valid slot, all of which
    lie within the window by construction. The padded heads are masked
    before the output projection, as in ``gqa_decode`` (``repro``'s ring
    decode leaves them out of the mask; ROADMAP §3)."""
    win = cache.k.shape[1]
    return _cached_decode(p, cfg, x, cache, cache.pos % win,
                          min(cache.pos + 1, win))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    """Latent cache: a compressed KV row (r) and the rope key (dr) per
    token, instead of 2 H dh."""

    c_kv: torch.Tensor  # (B, S_max, r)
    k_rope: torch.Tensor  # (B, S_max, dr)
    pos: int  # next write position


def mla_init(gen, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.padded_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, device=resolve_device(device))
    p = {
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, **kw),
        "w_kr": dense_init(gen, d, m.qk_rope_head_dim, **kw),
        "w_ukv": head_proj_init(gen, m.kv_lora_rank, h,
                                m.qk_nope_head_dim + m.v_head_dim, **kw),
        "wo": head_out_init(gen, h, m.v_head_dim, d, **kw),
    }
    if m.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, m.q_lora_rank, **kw)
        p["w_uq"] = head_proj_init(gen, m.q_lora_rank, h, qk, **kw)
    else:
        p["wq"] = head_proj_init(gen, d, h, qk, **kw)
    return p


def _mla_query(p, cfg: ModelConfig, x, cos, sin):
    """(q_nope, roped q_rope), each (B, S, H, .)."""
    dn = cfg.mla.qk_nope_head_dim
    if cfg.mla.q_lora_rank:
        q = head_proj(p["w_uq"], dense(p["w_dq"], x))
    else:
        q = head_proj(p["wq"], x)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin)


def _mla_keys(p, cfg: ModelConfig, c_kv, k_rope):
    """Expand latents (B, S, r) and rope keys (B, S, dr) into full keys
    (B, S, H, dn + dr) and values (B, S, H, dv)."""
    dn = cfg.mla.qk_nope_head_dim
    b, s, _ = c_kv.shape
    kv = head_proj(p["w_ukv"], c_kv)  # (B, S, H, dn + dv)
    k_rope = k_rope[:, :, None, :].expand(b, s, cfg.padded_heads,
                                         k_rope.shape[-1])
    return torch.cat([kv[..., :dn], k_rope], dim=-1), kv[..., dn:]


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              block_k: int = 1024, kernel_mode: str = "auto"):
    """Full-sequence causal MLA. x: (B, S, d). q and k have the same shape
    (H heads of dn + dr), so the dispatcher takes the flash kernel."""
    b, s, _ = x.shape
    dr = cfg.mla.qk_rope_head_dim
    positions = torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_nope, q_rope = _mla_query(p, cfg, x, cos, sin)
    k_rope = apply_rope(dense(p["w_kr"], x).reshape(b, s, 1, dr), cos, sin)
    k_full, v = _mla_keys(p, cfg, dense(p["w_dkv"], x), k_rope[:, :, 0])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q_full, k_full, v, causal=True, block_k=block_k,
                          kernel_mode=kernel_mode)
    return head_out(p["wo"], apply_head_mask(out, head_mask(cfg)))


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: MLACache):
    """One-token MLA decode from the latent cache. x: (B, 1, d).

    The new latent and rope key are written into the cache in place, as
    ``gqa_decode`` writes its KV cache. The latents are expanded, then
    dotted, as in ``repro`` (no weight absorption); only the ``pos + 1``
    valid rows are expanded, where ``repro`` expands all S_max and masks
    the rest (the same keys and values). Returns (out, the cache advanced
    by one position)."""
    b = x.shape[0]
    dr = cfg.mla.qk_rope_head_dim
    positions = torch.full((b, 1), cache.pos, dtype=torch.long,
                           device=x.device)
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_nope, q_rope = _mla_query(p, cfg, x, cos, sin)
    kr_new = apply_rope(dense(p["w_kr"], x)[:, :, None, :], cos, sin)[:, :, 0]
    cache.c_kv[:, cache.pos] = dense(p["w_dkv"], x)[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, cache.pos] = kr_new[:, 0].to(cache.k_rope.dtype)
    n = cache.pos + 1
    k_full, v = _mla_keys(p, cfg, cache.c_kv[:, :n], cache.k_rope[:, :n])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = dense_attention(q_full, k_full, v, causal=False)
    new_cache = MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope, pos=n)
    return head_out(p["wo"], apply_head_mask(out, head_mask(cfg))), new_cache
