"""Config system: one immutable dataclass per architecture.

Counterpart of ``repro/configs/base.py``, kept as the port's own copy (the
port imports nothing of ``repro``): the same fields, defaults, ``reduced()``
and ``param_count()``, with ``activation_dtype`` as a ``torch.dtype``.
Configurations describe shapes only; no weights are loaded.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

__all__ = ["MoEConfig", "MLAConfig", "ModelConfig", "SHAPES", "ShapeSpec"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (GShard-style capacity dispatch)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # shared (always-on) experts, deepseek-style
    dense_residual_ff: int = 0  # arctic: parallel dense FFN width (0 = off)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int
    q_lora_rank: int = 0  # 0 = no query compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 = d_model // num_heads
    # Pad query heads to this count for TP-axis divisibility (0 = off). The
    # extra heads are INERT: a constant zero head-mask before the output
    # projection keeps the function and all gradients exactly equal to the
    # unpadded architecture — the padding only buys an evenly-shardable head
    # axis. (GSPMD argument shardings must divide evenly.)
    pad_heads_to: int = 0
    attention: str = "gqa"  # gqa | mla | rff | none
    mixer: str = "attention"  # attention | mamba2 | rglru_hybrid
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    pad_vocab_to: int = 256  # vocab padding multiple (0 = off); inert slots

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # mamba2 (ssm)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # rglru hybrid (recurrentgemma): 1 local-attention block per `attn_every`
    lru_width: int = 0
    local_window: int = 2048
    attn_every: int = 3

    # RFF linear attention (the paper's technique; used natively when
    # attention == "rff", or substituted for long-context decode when
    # ``rff_long_context`` is True — see DESIGN.md long_500k policy)
    rff_num_features: int = 256
    rff_chunk: int = 256
    rff_long_context: bool = True

    # modality frontend stub: None | "vision" | "audio" — inputs arrive as
    # precomputed frame/patch embeddings (B, S, d_model) instead of token ids
    frontend: Optional[str] = None

    dtype: str = "bfloat16"
    # training
    remat: bool = True
    scan_layers: bool = True
    opt_dtype: str = "float32"  # adam moment dtype ("bfloat16" for 480B)
    # "tp":   TP on the model axis (+ ZeRO over data axes per zero_stage).
    # "dp":   replicate params, shard batch over every axis — the right
    #         mapping for sub-1B archs where 16-way TP is pure overhead.
    # "fsdp": shard weights' contraction dims over ALL axes, batch over all
    #         axes, weights all-gathered at use — the right mapping for
    #         1-40B dense models on 256 chips (weight-gather bytes are far
    #         below Megatron activation-AR bytes at these sizes).
    preferred_parallelism: str = "tp"
    # per-kind override: training deployments often want a different mapping
    # than serving (e.g. llama3: fsdp train / tp serve). Empty = preferred.
    train_parallelism: str = ""
    # ZeRO stage for optimizer/param sharding over the data axes:
    #  1 = params TP-only (replicated over data), adam moments data-sharded;
    #  3 = params also data-sharded (contraction dims) — needed when
    #      TP-sharded params alone exceed HBM (arctic-480b).
    zero_stage: int = 1
    # mesh axes carrying the batch dim of ACTIVATIONS inside the layer stack
    # (set by the launcher per cell). Without this constraint GSPMD may
    # resolve ZeRO-3 weight/activation conflicts by de-sharding the batch
    # and partial-sum all-reducing activations (observed on arctic-480b).
    activation_batch_axes: tuple = ()
    # explicit microbatch count for training (0 = one sequence per device);
    # larger microbatches amortize ZeRO-3 per-use weight gathers.
    train_microbatches: int = 0
    # stream the training loss logsumexp over this many vocab chunks
    # (1 = materialize full f32 logits)
    loss_vocab_chunks: int = 1
    # serve-time MoE layout: experts over `data` x expert-ff over `model`
    # (gather-free; tokens all-to-all to their experts). Set automatically
    # for zero-3 archs on non-train cells — re-gathering ZeRO-3 expert
    # shards per decoded token costs ~1.5 s/token (observed, arctic).
    expert_2d_shard: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up for TP divisibility; padded logit slots are
        masked to -inf so the function equals the unpadded model exactly."""
        if not self.pad_vocab_to:
            return self.vocab_size
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=2,
            d_model=64,
            pad_heads_to=0,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            local_window=32,
            rff_num_features=32,
            rff_chunk=16,
            ssm_chunk=16,
            lru_width=64 if self.lru_width else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16,
            dtype="float32",
            scan_layers=False,
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=32,
                num_shared=min(self.moe.num_shared, 1),
                dense_residual_ff=64 if self.moe.dense_residual_ff else 0,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32,
                q_lora_rank=16 if self.mla.q_lora_rank else 0,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        if self.family == "hybrid":
            kw["num_layers"] = 3  # one full (rec, rec, attn) pattern
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        dh = self.resolved_head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 2 * d  # norms
        if self.mixer == "attention":
            per_layer += self._attn_params(d, dh)
            per_layer += self._ffn_params(d)
        elif self.mixer == "mamba2":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_state
            per_layer += d * (2 * d_in + 2 * self.ssm_state + nheads)
            per_layer += conv_dim * self.conv_width
            per_layer += d_in * d  # out proj
            per_layer += 2 * nheads  # A, D
            per_layer += self._ffn_params(d)
        elif self.mixer == "rglru_hybrid":
            w = self.lru_width or d
            # recurrent block: in-proj x2, conv, lru gates x2 + lambda, out
            rec = d * w * 2 + w * self.conv_width + 2 * w * w + w + w * d
            att = self._attn_params(d, dh)
            per_layer += (2 * rec + att) / 3 + self._ffn_params(d)
        n += l * per_layer
        return int(n)

    def _attn_params(self, d: int, dh: int) -> int:
        if self.attention == "mla":
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * m.kv_lora_rank + d * m.qk_rope_head_dim
            n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            if m.q_lora_rank:
                n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
            else:
                n += d * self.num_heads * qk
            n += self.num_heads * m.v_head_dim * d
            return n
        n = d * self.num_heads * dh  # q
        n += 2 * d * self.num_kv_heads * dh  # k, v
        n += self.num_heads * dh * d  # o
        return n

    def _ffn_params(self, d: int) -> int:
        if self.moe is not None:
            m = self.moe
            expert = 3 * d * m.d_ff_expert  # gated MLP
            n = m.num_experts * expert + d * m.num_experts  # + router
            n += m.num_shared * expert
            if m.dense_residual_ff:
                n += 3 * d * m.dense_residual_ff
            return n
        return 3 * d * self.d_ff  # gated MLP (in, gate, out)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        expert = 3 * self.d_model * m.d_ff_expert
        inactive = (m.num_experts - m.top_k) * expert
        return int(self.param_count() - self.num_layers * inactive)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
