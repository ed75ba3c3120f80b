"""Decoder-only LM assembled from a ModelConfig.

Counterpart of ``repro/models/transformer.py``; one model covers all ten
archs:

* ``mixer="attention"``: a dense or MoE FFN under gqa, mla or rff
  attention (qwen2, llama3, command-r, deepseek, minicpm3, arctic,
  internvl2, musicgen);
* ``mixer="mamba2"``: SSD blocks with no FFN (mamba2);
* ``mixer="rglru_hybrid"``: groups of (recurrent, recurrent,
  local-attention) blocks with MLPs, then ``num_layers % 3`` more
  recurrent blocks (recurrentgemma).

The layers are a Python loop over a list of per-layer dicts
(``params["blocks"]``, one group a layer for the hybrid, its remainder
under ``params["extra"]``); ``repro`` scans stacked layers under jit.
``forward`` and ``decode_step`` take ``kernel_mode`` ("auto", "cuda" or
"ref") and pass it to the attention kernels, so the same model can run the
kernels or their plain versions on the card.

The parameters may be ``DTensor``s (``launch.sharding``'s placements). The
model makes plain tensors inside (masks, rope tables, constants), which
are the same on every rank, so the entry points run under DTensor's
``implicit_replication`` when a parameter or an input is a DTensor, and
``apply_stack`` pins the activations' batch sharding to
``cfg.activation_batch_axes`` (:func:`_constrain_batch`, ``repro``'s).
"""
from __future__ import annotations

import contextlib
from dataclasses import replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rff_attention as rff_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.optim.tree import leaves
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
    "num_scan_layers",
    "init_params",
    "apply_stack",
    "head_logits",
    "embed_inputs",
    "forward",
    "lm_loss",
    "decode_state_init",
    "decode_step",
]


def with_rff_attention(cfg: ModelConfig) -> ModelConfig:
    """Switch a full-attention config to RFF linear attention (the paper's
    fixed-size-state technique)."""
    return replace(cfg, attention="rff")


def num_scan_layers(cfg: ModelConfig) -> tuple[int, int]:
    """(entries of ``params["blocks"]``, extra recurrent blocks): the
    hybrid groups its layers by 3."""
    if cfg.mixer == "rglru_hybrid":
        return cfg.num_layers // 3, cfg.num_layers % 3
    return cfg.num_layers, 0


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------


def _attn_block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    if cfg.attention == "mla":
        attn = attn_mod.mla_init(gen, cfg, dtype, device=device)
    elif cfg.attention == "rff":
        attn = rff_mod.rff_attn_init(gen, cfg, dtype, device=device)
    else:
        attn = attn_mod.gqa_init(gen, cfg, dtype, device=device)
    if cfg.moe is not None:
        ffn = moe_mod.moe_init(gen, cfg, dtype, device=device)
    else:
        ffn = glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device), "attn": attn,
            "ln2": rmsnorm_init(cfg.d_model, dtype, device), "ffn": ffn}


def _ffn(p, cfg: ModelConfig, h):
    if cfg.moe is not None:
        return moe_mod.moe_apply(p, cfg, h)
    return glu_mlp(p, h)


def _attn_block_apply(p, cfg: ModelConfig, x, kernel_mode):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        a = attn_mod.mla_apply(p["attn"], cfg, h, kernel_mode=kernel_mode)
    elif cfg.attention == "rff":
        a = rff_mod.rff_attn_apply(p["attn"], cfg, h, kernel_mode=kernel_mode)
    else:
        a = attn_mod.gqa_apply(p["attn"], cfg, h, kernel_mode=kernel_mode)
    x = x + a
    return x + _ffn(p["ffn"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps))


def _mamba_block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "mixer": ssm_mod.mamba2_init(gen, cfg, dtype, device=device)}


def _mamba_block_apply(p, cfg: ModelConfig, x, kernel_mode):
    return x + ssm_mod.mamba2_apply(p["mixer"], cfg,
                                    rmsnorm(p["ln1"], x, cfg.norm_eps))


def _rec_block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "temporal": rglru_mod.rglru_init(gen, cfg, dtype, device=device),
            "ln2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _rec_block_apply(p, cfg: ModelConfig, x):
    x = x + rglru_mod.rglru_apply(p["temporal"], cfg,
                                  rmsnorm(p["ln1"], x, cfg.norm_eps))
    return x + glu_mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def _local_attn_block_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_mod.gqa_init(gen, cfg, dtype, device=device),
            "ln2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": glu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def _local_attn_block_apply(p, cfg: ModelConfig, x, kernel_mode):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.gqa_apply(p["attn"], cfg, h, window=cfg.local_window,
                               kernel_mode=kernel_mode)
    return x + glu_mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def _hybrid_group_init(gen, cfg: ModelConfig, dtype, device) -> dict:
    """(recurrent, recurrent, local-attention) group."""
    return {"rec1": _rec_block_init(gen, cfg, dtype, device),
            "rec2": _rec_block_init(gen, cfg, dtype, device),
            "attn": _local_attn_block_init(gen, cfg, dtype, device)}


def _hybrid_group_apply(p, cfg: ModelConfig, x, kernel_mode):
    x = _rec_block_apply(p["rec1"], cfg, x)
    x = _rec_block_apply(p["rec2"], cfg, x)
    return _local_attn_block_apply(p["attn"], cfg, x, kernel_mode)


_BLOCKS = {  # mixer -> (init, apply)
    "attention": (_attn_block_init, _attn_block_apply),
    "mamba2": (_mamba_block_init, _mamba_block_apply),
    "rglru_hybrid": (_hybrid_group_init, _hybrid_group_apply),
}


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> dict:
    """Random parameters in ``cfg.activation_dtype`` on ``device``, drawn
    from ``gen`` on its own device (pass a CUDA generator for a full-size
    model on the card). Weights are random: configurations are shapes."""
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    n_scan, n_extra = num_scan_layers(cfg)
    layer_init = _BLOCKS[cfg.mixer][0]
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": [layer_init(gen, cfg, dtype, dev) for _ in range(n_scan)],
    }
    if n_extra:  # hybrid remainder: recurrent blocks
        params["extra"] = [_rec_block_init(gen, cfg, dtype, dev)
                           for _ in range(n_extra)]
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                    dtype=dtype, device=dev)
    return params


def dtensor_scope(*trees):
    """``implicit_replication()`` when a leaf of ``trees`` is a DTensor
    (plain tensors made inside the model then act as replicated), else a
    null context. Nested scopes keep the outer one's setting (DTensor's
    context turns it off on exit)."""
    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return contextlib.nullcontext()
    for tree in trees:
        if any(isinstance(t, DTensor) for t in leaves(tree)):
            return implicit_replication()
    return contextlib.nullcontext()


def _constrain_batch(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Pin the activation batch sharding through the layer stack
    (``cfg.activation_batch_axes``): a DTensor is redistributed to
    ``Shard(0)`` on the mesh dims of those axes and ``Replicate()`` on the
    others, ``repro``'s ``with_sharding_constraint`` of ``P(axes, None,
    ...)``. A plain tensor, or an empty ``activation_batch_axes``, passes
    through."""
    axes = cfg.activation_batch_axes
    if not axes or not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"activation_batch_axes {axes}: {missing} not on "
                         f"the mesh {names}")
    want = tuple(Shard(0) if n in axes else Replicate() for n in names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def apply_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                kernel_mode: str = "auto") -> torch.Tensor:
    """The layer stack over hidden states x (B, S, d)."""
    apply = _BLOCKS[cfg.mixer][1]
    x = _constrain_batch(cfg, x)
    for layer_p in params["blocks"]:
        x = _constrain_batch(cfg, apply(layer_p, cfg, x, kernel_mode))
    for extra_p in params.get("extra", []):
        x = _rec_block_apply(extra_p, cfg, x)
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


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows of ``table`` (V, d). A DTensor table sharded by vocab is
    looked up vocab-parallel: each rank takes the tokens that fall in its
    rows (zeros elsewhere) and the rows sum over the vocab's mesh dims
    (``Partial``), with no masked-partial placement (whose mask buffer some
    DTensor versions lose). Where the tokens are split on a mesh dim that
    also splits the vocab, the table is gathered on that dim first."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    rows = (tokens.placements if isinstance(tokens, DTensor)
            else (Replicate(),) * mesh.ndim)
    vocab = tuple(type(p) is Shard and p.dim == 0
                  and type(r) is Replicate
                  for p, r in zip(table.placements, rows))
    want = tuple(Shard(0) if v else Replicate() for v in vocab)
    if want != tuple(table.placements):
        table = table.redistribute(mesh, want)
    if not any(vocab):
        return F.embedding(tokens, table)
    # This rank's rows [lo, lo + n): Shard(0) cuts in mesh order, chunks of
    # ceil(rows / ranks) (torch.chunk's, DTensor's).
    lo, n = 0, table.shape[0]
    for v, k, c in zip(vocab, mesh.shape, mesh.get_coordinate()):
        if v:
            step = -(-n // k)
            lo, n = lo + min(c * step, n), max(0, min(step, n - c * step))
    local = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    idx = local - lo
    inside = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, max(n - 1, 0)), table.to_local())
    out = out * inside[..., None].to(out.dtype)
    places = tuple(Partial() if v else r for v, r in zip(vocab, rows))
    shape = torch.Size((*tokens.shape, table.shape[1]))
    return DTensor.from_local(out, mesh, places, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def embed_inputs(params: dict, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token ids (B, S) through the embedding table, or precomputed
    frontend embeddings (B, S, d) cast to the activation dtype."""
    if embeds is None:
        return _embed(params["embed"]["table"], tokens)
    return embeds.to(cfg.activation_dtype)


def forward(params: dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, *,
            kernel_mode: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) int, or for the frontend
    archs embeds (B, S, d) -> logits (B, S, V_padded)."""
    with dtensor_scope(params, tokens, embeds):
        x = apply_stack(params, cfg, embed_inputs(params, cfg, tokens,
                                                  embeds),
                        kernel_mode=kernel_mode)
        return head_logits(params, cfg, x)


def lm_loss(params: dict, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None, *,
            kernel_mode: str = "auto") -> torch.Tensor:
    """Next-token cross entropy (f32 logsumexp), the mean over the labelled
    tokens: a 0-d f32 tensor.

    The labels are ``tokens`` shifted by one (the last position masked),
    or ``labels`` with -1 masked (the frontend archs, which pass
    ``embeds``). ``cfg.loss_vocab_chunks = nc > 1`` streams the logsumexp
    over nc vocab chunks when nc divides the padded vocab (a running max
    from -1e30 and a rescaled sum; the gold logit taken from the chunk that
    holds it), so no f32 copy of the full-vocab logits is made; otherwise
    the plain route, as in ``repro``."""
    with dtensor_scope(params, tokens, embeds, labels):
        return _lm_loss(params, cfg, tokens, embeds, labels, kernel_mode)


def _lm_loss(params, cfg, tokens, embeds, labels, kernel_mode):
    logits = forward(params, cfg, tokens=tokens, embeds=embeds,
                     kernel_mode=kernel_mode)
    if labels is None:
        # The next token, and a mask of ones but the last position: joined
        # rather than padded or filled, ops DTensor places on any mesh.
        last = torch.zeros_like(tokens[:, :1])
        labels = torch.cat((tokens[:, 1:], last), dim=1)
        mask = torch.cat((torch.ones_like(tokens[:, 1:]), last), dim=1)
    else:
        mask = (labels >= 0).to(torch.int32)
        labels = torch.clamp(labels, min=0)
    labels = labels.long()
    nc = max(int(cfg.loss_vocab_chunks), 1)
    vp = logits.shape[-1]
    if nc > 1 and vp % nc == 0:
        vc = vp // nc
        m = torch.full(labels.shape, -1e30, dtype=torch.float32,
                       device=logits.device)
        s = torch.zeros_like(m)
        gold = torch.zeros_like(m)
        for idx in range(nc):
            c32 = logits[..., idx * vc:(idx + 1) * vc].float()
            m_new = torch.maximum(m, c32.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                c32 - m_new[..., None]).sum(dim=-1)
            local = labels - idx * vc
            hit = (local >= 0) & (local < vc)
            g = _gather_last(c32, local.clamp(0, vc - 1))
            gold = torch.where(hit, g, gold)
            m = m_new
        lse = m + torch.log(s)
    else:
        lg = _rows_like(logits.float(), labels)
        lse = torch.logsumexp(lg, dim=-1)
        gold = _gather_last(lg, labels)
    nll = (lse - gold) * mask
    return _total(nll) / torch.clamp(_total(mask), min=1)


def _total(x: torch.Tensor) -> torch.Tensor:
    """The sum of every element of ``x``, a 0-d tensor. For a DTensor a
    plain one: each rank sums its local shard and one all-reduce (under
    autograd) adds the shards. DTensor's own sum makes a 0-d DTensor, whose
    gradient's expand some DTensor versions cannot place on a mesh of two or
    more dims."""
    if not isinstance(x, DTensor):
        return x.sum()
    mesh = x.device_mesh
    parts = [Partial() if p.is_partial() or isinstance(p, (Shard,
                                                           _StridedShard))
             else Replicate() for p in x.placements]
    local = DTensor.from_local(x.to_local().sum().reshape(1), mesh, parts,
                               run_check=False)
    return local.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
    ).reshape(())


def _rows_like(x: torch.Tensor, index) -> torch.Tensor:
    """A DTensor ``x`` (..., V) placed as ``index`` (...) is, its last dim
    whole on each rank; a plain ``x`` as it is."""
    if not isinstance(x, DTensor):
        return x
    places = (index.placements if isinstance(index, DTensor)
              else (Replicate(),) * x.device_mesh.ndim)
    if tuple(x.placements) == tuple(places):
        return x
    return x.redistribute(x.device_mesh, places)


def _gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` along the last dim (``torch.gather``). On DTensors
    the gather runs on each rank's rows (``x`` placed as ``index`` first),
    so its gradient stays there too: DTensor's own gather backward fills a
    zero tensor of the global shape on every rank."""
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    x = _rows_like(x, index)
    local = index.to_local() if isinstance(index, DTensor) else index
    out = torch.gather(x.to_local(), -1, local[..., None])[..., 0]
    shape = torch.Size(x.shape[:-1])
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------


def _kv_cache(cfg: ModelConfig, batch: int, slots: int, device):
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = cfg.activation_dtype
    return attn_mod.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device),
                            pos=0)


def _block_state_init(cfg: ModelConfig, batch: int, max_len: int, device):
    if cfg.mixer == "mamba2":
        return ssm_mod.mamba2_state_init(cfg, batch, device=device)
    if cfg.mixer == "rglru_hybrid":
        return {
            "rec1": rglru_mod.rglru_state_init(cfg, batch, device=device),
            "rec2": rglru_mod.rglru_state_init(cfg, batch, device=device),
            # ring buffer of the window's size
            "attn": _kv_cache(cfg, batch, min(cfg.local_window, max_len),
                              device),
        }
    if cfg.attention == "rff":
        return rff_mod.rff_state_init(cfg, batch, device=device)
    if cfg.attention == "mla":
        m, dtype = cfg.mla, cfg.activation_dtype
        return attn_mod.MLACache(
            c_kv=torch.zeros(batch, max_len, m.kv_lora_rank, dtype=dtype,
                             device=device),
            k_rope=torch.zeros(batch, max_len, m.qk_rope_head_dim,
                               dtype=dtype, device=device),
            pos=0)
    return _kv_cache(cfg, batch, max_len, device)


def decode_state_init(cfg: ModelConfig, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """Per-layer decode state ``{"stack": [one per entry of
    params["blocks"]], "extra": [one per extra recurrent block]}``: a KV
    cache of ``max_len``, an MLA latent cache of ``max_len``, the
    fixed-size RFF or mamba2 state, or the hybrid's two RG-LRU states and
    a ring KV cache of ``min(local_window, max_len)`` slots."""
    dev = resolve_device(device)
    n_scan, n_extra = num_scan_layers(cfg)
    return {"stack": [_block_state_init(cfg, batch, max_len, dev)
                      for _ in range(n_scan)],
            "extra": [rglru_mod.rglru_state_init(cfg, batch, device=dev)
                      for _ in range(n_extra)]}


def _rec_block_decode(p, cfg: ModelConfig, x, state):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, state = rglru_mod.rglru_decode(p["temporal"], cfg, h, state)
    x = x + out
    return x + glu_mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps)), state


def _block_decode(p, cfg: ModelConfig, x, state, kernel_mode):
    if cfg.mixer == "mamba2":
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        out, new_state = ssm_mod.mamba2_decode(p["mixer"], cfg, h, state)
        return x + out, new_state
    if cfg.mixer == "rglru_hybrid":
        x, s1 = _rec_block_decode(p["rec1"], cfg, x, state["rec1"])
        x, s2 = _rec_block_decode(p["rec2"], cfg, x, state["rec2"])
        pa = p["attn"]
        h = rmsnorm(pa["ln1"], x, cfg.norm_eps)
        out, s3 = attn_mod.ring_gqa_decode(pa["attn"], cfg, h, state["attn"])
        x = x + out
        x = x + glu_mlp(pa["mlp"], rmsnorm(pa["ln2"], x, cfg.norm_eps))
        return x, {"rec1": s1, "rec2": s2, "attn": s3}
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "rff":
        out, new_state = rff_mod.rff_attn_decode(p["attn"], cfg, h, state,
                                                 kernel_mode=kernel_mode)
    elif cfg.attention == "mla":
        out, new_state = attn_mod.mla_decode(p["attn"], cfg, h, state)
    else:
        out, new_state = attn_mod.gqa_decode(p["attn"], cfg, h, state)
    x = x + out
    return (x + _ffn(p["ffn"], cfg, rmsnorm(p["ln2"], x, cfg.norm_eps)),
            new_state)


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                token: Optional[torch.Tensor] = None,
                embed_in: Optional[torch.Tensor] = None, *,
                kernel_mode: str = "auto"):
    """One serving step: token (B,) int, or for the frontend archs
    embed_in (B, 1, d) -> (logits (B, V_padded), the new state). KV and
    MLA caches are written in place."""
    with dtensor_scope(params, token, embed_in):
        return _decode_step(params, cfg, state, token, embed_in, kernel_mode)


def _decode_step(params, cfg, state, token, embed_in, kernel_mode):
    x = embed_inputs(params, cfg,
                     None if token is None else token[:, None], embed_in)
    new_stack = []
    for layer_p, layer_s in zip(params["blocks"], state["stack"]):
        x, s = _block_decode(layer_p, cfg, x, layer_s, kernel_mode)
        new_stack.append(s)
    new_extra = []
    for extra_p, extra_s in zip(params.get("extra", []), state["extra"]):
        x, s = _rec_block_decode(extra_p, cfg, x, extra_s)
        new_extra.append(s)
    return (head_logits(params, cfg, x)[:, 0],
            {"stack": new_stack, "extra": new_extra})
