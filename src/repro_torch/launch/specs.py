"""Input stand-ins and placements for every (arch x shape) cell.

Counterpart of ``repro/launch/specs.py``. :func:`input_specs` gives the
batch the dry-run runs against as ``(shape, dtype)`` records, allocating
nothing (``repro``'s ``ShapeDtypeStruct``s); :func:`decode_state_shape`
runs ``transformer.decode_state_init`` under ``FakeTensorMode``, the
counterpart of ``jax.eval_shape``. :func:`resolve_cell` applies the
long_500k policy (RFF substitution for full-attention archs, the paper's
technique) and the serve and train remaps.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import (
    NamedSharding,
    _axis_sizes,
    _batch_dim_spec,
    decode_state_specs,
    placements,
    tree_map_with_path,
)
from repro_torch.models import transformer

__all__ = [
    "TensorSpec",
    "resolve_cell",
    "input_specs",
    "input_shardings",
    "dp_size",
    "train_batch_axes",
    "decode_state_shape",
    "decode_state_shardings",
]


class TensorSpec(NamedTuple):
    """A shape and a dtype, with no storage (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def dp_size(mesh) -> int:
    sizes = _axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def train_batch_axes(cfg: ModelConfig, shape: ShapeSpec,
                     mesh) -> tuple[str, ...]:
    """Mesh axes the batch dim is sharded over.

    TP mode: the data-like axes. DP and FSDP modes (train and prefill):
    greedily extend over every axis (pod, data, model) while the global
    batch stays divisible."""
    sizes = _axis_sizes(mesh)
    if (cfg.preferred_parallelism in ("dp", "fsdp")
            and shape.kind in ("train", "prefill")):
        names = tuple(sizes)
    else:
        names = data_axes(mesh)
    axes: list[str] = []
    prod = 1
    for a in names:
        if shape.global_batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def resolve_cell(cfg: ModelConfig, shape: ShapeSpec) -> tuple[ModelConfig,
                                                                str]:
    """Apply per-cell policy. Returns (possibly modified cfg, note)."""
    note = "native"
    if shape.name == "long_500k" and cfg.mixer == "attention":
        if cfg.attention in ("gqa", "mla") and cfg.rff_long_context:
            cfg = transformer.with_rff_attention(cfg)
            note = ("rff-substituted (paper technique: fixed-size state "
                    "replaces KV cache)")
    if shape.kind != "train" and cfg.zero_stage >= 3:
        # no optimizer state at serve time: drop ZeRO-3 for the
        # gather-free 2D expert layout.
        cfg = replace(cfg, zero_stage=1, expert_2d_shard=True)
        note += " + serve=2d-expert-shard"
    if shape.kind == "train" and cfg.train_parallelism:
        kw = dict(preferred_parallelism=cfg.train_parallelism)
        if cfg.train_parallelism in ("dp", "fsdp"):
            kw["pad_heads_to"] = 0
        cfg = replace(cfg, **kw)
        note += f" + train={cfg.preferred_parallelism}"
    return cfg, note


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """The batch of one cell as :class:`TensorSpec` records (token ids, or
    the stub frontend's embeddings)."""
    b, s = shape.global_batch, shape.seq_len
    tok_dt = torch.int32
    emb_dt = cfg.activation_dtype
    if shape.kind in ("train", "prefill"):
        if cfg.frontend:
            batch = {"embeds": TensorSpec((b, s, cfg.d_model), emb_dt)}
            if shape.kind == "train":
                batch["labels"] = TensorSpec((b, s), tok_dt)
        else:
            batch = {"tokens": TensorSpec((b, s), tok_dt)}
        return batch
    # decode: one new token against a seq_len-deep context state
    if cfg.frontend:
        return {"embed": TensorSpec((b, 1, cfg.d_model), emb_dt)}
    return {"token": TensorSpec((b,), tok_dt)}


def input_shardings(cfg: ModelConfig, shape: ShapeSpec,
                    mesh) -> dict[str, NamedSharding]:
    if shape.kind in ("train", "prefill"):
        baxes = train_batch_axes(cfg, shape, mesh) or None
    else:
        bspec = _batch_dim_spec(mesh, shape.global_batch)
        baxes = bspec[0] if bspec else None
    out = {}
    for name in input_specs(cfg, shape):
        if name in ("tokens", "labels"):
            spec = (baxes, None)
        elif name == "token":
            spec = (baxes,)
        else:  # embeds / embed
            spec = (baxes, None, None)
        out[name] = NamedSharding(mesh, placements(spec, mesh))
    return out


def decode_state_shape(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """The decode-state tree of a cell as fake tensors (no allocation), in
    the active ``FakeTensorMode`` if there is one."""
    import contextlib

    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    with (contextlib.nullcontext() if detect_fake_mode() is not None
          else FakeTensorMode()):
        return transformer.decode_state_init(cfg, shape.global_batch,
                                             max_len=shape.seq_len,
                                             device="cpu")


def decode_state_shardings(cfg: ModelConfig, shape: ShapeSpec,
                           mesh) -> Any:
    st_shape = decode_state_shape(cfg, shape)
    specs = decode_state_specs(cfg, mesh, st_shape, shape.global_batch)
    return tree_map_with_path(lambda names, leaf, s: NamedSharding(mesh, s),
                              st_shape, specs)
