"""Sharding rules for params, optimizer state, inputs and decode state.

Counterpart of ``repro/launch/sharding.py``: the same rules over the same
parameter-tree paths and shapes, as ``DTensor`` placements. The strategy
(``repro``'s DESIGN.md §6), per arch and per deployment kind:

* ``tp`` (serve default): TP on the ``model`` axis over head-structured /
  hidden / expert / vocab dims, head interiors never split. ZeRO-1: params
  replicated over data, AdamW moments data-sharded (:func:`moment_specs`).
* ``zero_stage=3`` (arctic-480b train): contraction dims also sharded over
  data.
* ``fsdp`` (train, <= 35B archs): each weight's largest divisible dim
  sharded over ALL axes, the batch over all axes.
* ``dp`` (qwen2, mamba2): params replicated, the batch over every axis.
* serve-time MoE for zero-3 archs: the gather-free 2-D expert layout
  (E x data, expert-ff x model).
* decode: KV caches sequence-sharded over ``model``; the fixed-size
  RFF/SSM/LRU states shard heads or features.

A ``repro`` ``PartitionSpec`` becomes a tuple of placements, one per mesh
dim (:func:`placements`): an axis named on a tensor dim gives ``Shard(dim)``
on that mesh dim, an axis named nowhere ``Replicate()``, and a tuple of
axes on one dim shards it over those mesh dims major to minor in the
tuple's order. Where that order is not the mesh's (the MLA latent cache at
B = 1: ``("model",) + dp`` on a data-major mesh), the mesh dims that come
first in the mesh but later in the tuple take ``_StridedShard`` with the
product of the later-in-mesh, earlier-in-tuple axes as the split factor,
so each rank holds the rows GSPMD gives it. An uneven dim (14 heads over
16) gives the same rows as GSPMD's padding: both split by ceil(n / k).

The rules take any mesh-like object with ``.shape`` (a mapping from axis
name to size, as a JAX mesh's, or a ``DeviceMesh``'s tuple) and
``.axis_names`` or ``.mesh_dim_names``, so they run with no process group.
The spec trees mirror the parameter tree; map them driven by the parameter
tree (a placements tuple is a tuple).

``repro`` scan-stacks the layers (a leading layer dim on each leaf under
``blocks``); the port keeps ``blocks`` as a list of per-layer dicts. A port
leaf ``blocks[i].…`` takes ``repro``'s spec of ``blocks.…`` without its
leading ``None``. The rules that choose a dim by size (fsdp, the ZeRO-1
moments) see the stacked shape when ``cfg.scan_layers``, as ``repro``'s do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.placement_types import Placement, _StridedShard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import _axis_names, data_axes

__all__ = [
    "param_specs",
    "param_shardings",
    "moment_specs",
    "batch_specs",
    "decode_state_specs",
    "krls_state_shardings",
    "krls_feature_shardings",
    "krls_shard_bytes",
    "named",
    "NamedSharding",
    "placements",
    "distribute",
    "tree_map_with_path",
]


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one placement per mesh dim (``jax``'s ``NamedSharding``
    of a mesh and a ``PartitionSpec``)."""

    mesh: Any
    placements: tuple


def named(mesh, spec) -> NamedSharding:
    """``spec``, a placements tuple or a ``PartitionSpec``-like tuple of
    per-dim axis entries, on ``mesh``."""
    return NamedSharding(mesh, placements(spec, mesh))


def _axis_sizes(mesh) -> dict:
    shape = mesh.shape
    if hasattr(shape, "keys"):
        return dict(shape)
    return dict(zip(_axis_names(mesh), tuple(shape)))


def placements(spec, mesh) -> tuple:
    """One placement per mesh dim for ``spec``, a tuple of per-tensor-dim
    entries (None, an axis name, or a tuple of axis names major to minor),
    as ``repro``'s ``PartitionSpec``. A tuple that is already placements
    (one per mesh dim) is returned as it is."""
    names = _axis_names(mesh)
    spec = tuple(spec)
    if spec and all(isinstance(p, Placement) for p in spec):
        if len(spec) != len(names):
            raise ValueError(f"{spec} is not one placement a mesh dim of "
                             f"{names}")
        return spec
    sizes = _axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for i, axis in enumerate(axes):
            if axis not in names:
                raise ValueError(f"axis {axis!r} is not on the mesh {names}")
            k = names.index(axis)
            if not isinstance(out[k], Replicate):
                raise ValueError(f"axis {axis!r} shards two dims of {spec}")
            # Axes earlier in the tuple (more major) but later on the mesh
            # split this mesh dim's shards into strided pieces.
            split = 1
            for major in axes[:i]:
                if names.index(major) > k:
                    split *= sizes[major]
            out[k] = (Shard(dim) if split == 1
                      else _StridedShard(dim, split_factor=split))
    return tuple(out)


def _key(k) -> str:
    return f"[{k}]" if isinstance(k, int) else str(k)


def tree_map_with_path(fn, tree, *rest, _path=()):
    """``fn(names, leaf, *rest_leaves)`` over a port tree (dicts, lists,
    NamedTuples; any other value is a leaf), ``names`` as ``repro``'s
    ``_key_names``: a dict key, ``"[i]"`` for a list or tuple index, a
    NamedTuple's field name. The output keeps ``tree``'s structure; the
    ``rest`` trees are followed where ``tree`` goes."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=_path + (_key(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        vals = [tree_map_with_path(
            fn, v, *(r[i] for r in rest),
            _path=_path + ((fields[i],) if fields else (f"[{i}]",)))
            for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return vals
        return type(tree)(*vals) if fields else tuple(vals)
    return fn(list(_path), tree, *rest)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _model_ok(n: int, model_size: int) -> bool:
    return n % model_size == 0


def _leaf_spec(names: list, shape: tuple, cfg: ModelConfig, fsdp,
               model_size: int) -> tuple:
    """``repro``'s rule for one (unstacked) parameter leaf, as a tuple of
    per-dim axis entries.

    Attention projections are 3D head-structured (d, H, dh)/(H, dh, d): the
    head axis is sharded on ``model`` directly, so head interiors are never
    split."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    dims = list(shape)
    base_ndim = len(dims)

    def wrap(*spec_dims) -> tuple:
        return tuple(list(spec_dims) + [None] * (base_ndim - len(spec_dims)))

    # kv projections keep their (few) heads replicated, except under RFF
    # attention, whose k/v are full-headed.
    kv_model = cfg.attention == "rff"

    if base_ndim == 0:
        return wrap()
    if base_ndim == 1:
        if (name in ("conv_b", "norm_scale", "lam")
                and cfg.mixer == "rglru_hybrid"
                and _model_ok(dims[0], model_size)):
            return wrap("model")
        return wrap(None)

    # embeddings / head (d_model stays replicated)
    if name == "table":  # (V, d)
        return wrap("model", None)
    if parent == "head":  # (d, V)
        return wrap(None, "model")

    # MoE expert stacks (E, d, ff) / (E, ff, d)
    if gparent == "experts" or parent == "experts":
        if cfg.expert_2d_shard:
            if name in ("wi", "wg"):
                return wrap("data", None, "model")
            if name == "wo":
                return wrap("data", "model", None)
        e_ok = cfg.moe is not None and _model_ok(cfg.moe.num_experts,
                                                  model_size)
        eaxis = "model" if e_ok else None
        if name in ("wi", "wg"):
            return wrap(eaxis, fsdp, None)
        if name == "wo":
            return wrap(eaxis, None, fsdp)
    if parent == "router":  # (d, E)
        return wrap(fsdp, None)

    # convs: rglru (Hp, hd, W) head-structured / mamba (C, W)
    if name == "conv_w":
        if cfg.mixer == "rglru_hybrid":
            return wrap("model", None, None)
        return wrap(None, None)
    if name == "conv_b" and cfg.mixer == "rglru_hybrid":
        return wrap("model", None)
    if name == "lam":  # (Hp, hd)
        return wrap("model", None)
    if name in ("w_r", "w_i") and base_ndim == 3:  # block-diag gates
        return wrap("model", None, None)

    # MLA latents (2D) + head-structured up-projections (3D)
    if parent in ("w_dq", "w_dkv", "w_kr"):  # (d, r)
        return wrap(fsdp, None)
    if parent in ("w_uq", "w_ukv"):  # (r, H, x)
        return wrap(None, "model", None)

    # RFF feature buffers (dh, D): replicated
    if name == "omega":
        return wrap(None, None)
    if name == "bias" and gparent == "attn" and base_ndim == 1:
        return wrap(None)

    # attention projections (3D head-structured)
    if parent == "wq":
        if name == "b":  # (H, dh)
            return wrap("model", None)
        return wrap(fsdp, "model", None)  # (d, H, dh)
    if parent in ("wk", "wv"):
        if name == "b":
            return wrap("model" if kv_model else None, None)
        return wrap(fsdp, "model" if kv_model else None, None)
    if parent == "wo" and base_ndim == 3:  # (H, dh, d)
        return wrap("model", None, fsdp)

    # mamba2: d_inner projections stay model-replicated
    if cfg.mixer == "mamba2":
        if parent == "w_in":
            return wrap(fsdp, None)
        if parent == "w_out":
            return wrap(None, fsdp)

    # rglru (gparent == "temporal"): head-structured like attention
    if parent in ("w_x", "w_gate"):  # (d, Hp, hd)
        return wrap(fsdp, "model", None)
    if parent == "w_out" and gparent == "temporal":  # (Hp, hd, d)
        return wrap("model", None, fsdp)

    # generic MLP (ffn / mlp / shared / dense_residual)
    if parent in ("wi", "wg"):  # (d, ff)
        return wrap(fsdp, "model" if _model_ok(dims[1], model_size)
                    else None)
    if parent == "wo":  # (ff, d)
        return wrap("model" if _model_ok(dims[0], model_size) else None,
                    fsdp)

    return wrap(None)


def _stacked_dims(names: list, shape: tuple, cfg: ModelConfig) -> tuple:
    """The leaf's dims as ``repro`` holds them: with the layer count first
    under ``blocks`` when ``cfg.scan_layers``."""
    if cfg.scan_layers and names and names[0] == "blocks":
        from repro_torch.models.transformer import num_scan_layers

        return (num_scan_layers(cfg)[0],) + tuple(shape), 1
    return tuple(shape), 0


def _pick_dim(dims: tuple, parts: list, divisor: int, lead: int, names):
    """``repro``'s choice: the largest still-replicated dim divisible by
    ``divisor``. A port leaf has no layer dim to shard."""
    best, best_size = None, 0
    for i, (d, p) in enumerate(zip(dims, parts)):
        if p is None and d % divisor == 0 and d > best_size:
            best, best_size = i, d
    if best is not None and best < lead:
        raise NotImplementedError(
            f"{'.'.join(names)}: repro shards the stacked layer dim "
            f"({dims[0]} layers over {divisor}), which a per-layer leaf "
            "cannot hold")
    return best


def _fsdp_spec(names: list, shape: tuple, cfg: ModelConfig, axes: tuple,
               total: int) -> tuple:
    dims, lead = _stacked_dims(names, shape, cfg)
    if len(dims) < 2:
        return (None,) * len(shape)
    best = _pick_dim(dims, [None] * len(dims), total, lead, names)
    spec = [None] * len(dims)
    if best is not None:
        spec[best] = axes
    return tuple(spec[lead:])


def _dim_specs(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    """``repro``'s ``PartitionSpec`` of each leaf (unstacked), as a tuple
    of per-dim axis entries."""
    sizes = _axis_sizes(mesh)
    if getattr(cfg, "preferred_parallelism", "tp") == "dp":
        return tree_map_with_path(
            lambda names, leaf: (None,) * len(_shape(leaf)), params_shape)
    if cfg.preferred_parallelism == "fsdp":
        axes = _axis_names(mesh)
        total = 1
        for a in axes:
            total *= sizes[a]
        return tree_map_with_path(
            lambda names, leaf: _fsdp_spec(names, _shape(leaf), cfg, axes,
                                           total), params_shape)
    fsdp = data_axes(mesh) if cfg.zero_stage >= 3 else None
    model_size = sizes["model"]
    return tree_map_with_path(
        lambda names, leaf: _leaf_spec(names, _shape(leaf), cfg, fsdp,
                                       model_size), params_shape)


def param_specs(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    """Placements of every leaf of ``params_shape`` (tensors, fake tensors
    or anything with ``.shape``), a tree of its structure.

    ``preferred_parallelism == "dp"``: every param replicated (the batch
    is sharded over every mesh axis instead, ``specs.train_batch_axes``);
    ``"fsdp"``: each weight's largest dim divisible by the mesh size over
    all axes; otherwise TP on ``model`` with ZeRO-1 (or ZeRO-3 for
    ``zero_stage >= 3``, contraction dims over the data axes)."""
    return tree_map_with_path(
        lambda names, leaf, spec: placements(spec, mesh), params_shape,
        _dim_specs(cfg, mesh, params_shape))


def _moment_dim_specs(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    dp = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]

    def add(names, leaf, spec):
        parts = list(spec)
        for p in parts:
            axes = p if isinstance(p, tuple) else (p,)
            if p is not None and ("data" in axes or "pod" in axes):
                return spec  # already data-sharded (zero-3 leaf)
        dims, lead = _stacked_dims(names, _shape(leaf), cfg)
        best = _pick_dim(dims, [None] * lead + parts, dp_total, lead, names)
        if best is None:
            return spec
        parts[best - lead] = dp if len(dp) > 1 else dp[0]
        return tuple(parts)

    return tree_map_with_path(add, params_shape,
                              _dim_specs(cfg, mesh, params_shape))


def moment_specs(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    """AdamW moment placements: the param placements plus the data axes on
    the largest still-replicated dim divisible by their extent (ZeRO-1
    optimizer-state sharding)."""
    return tree_map_with_path(
        lambda names, leaf, spec: placements(spec, mesh), params_shape,
        _moment_dim_specs(cfg, mesh, params_shape))


def param_shardings(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    return tree_map_with_path(
        lambda names, leaf, spec: NamedSharding(mesh, spec), params_shape,
        param_specs(cfg, mesh, params_shape))


def krls_state_shardings(mesh, axis: Optional[str] = None):
    """``NamedSharding``s of the sharded-KRLS ``RLSState`` on the 1-D
    ``mesh``: theta and P row-block partitioned, the step replicated (the
    placements of ``core.krls.krls_state_specs``)."""
    from repro_torch.core.krls import KRLS_SHARD_AXIS, krls_state_specs

    specs = krls_state_specs(axis or KRLS_SHARD_AXIS)
    return type(specs)(*(NamedSharding(mesh, s) for s in specs))


def krls_feature_shardings(mesh, axis: Optional[str] = None):
    """``NamedSharding``s of the canonical trig feature bank: omega's
    columns, bias and scale partitioned, so each shard featurizes exactly
    its P row block's slice."""
    from repro_torch.core.krls import KRLS_SHARD_AXIS, krls_feature_specs

    specs = krls_feature_specs(axis or KRLS_SHARD_AXIS)
    return type(specs)(*(NamedSharding(mesh, s) for s in specs))


def krls_shard_bytes(num_features: int, n_shards: int, input_dim: int = 0,
                     itemsize: int = 4) -> dict:
    """Per-shard memory model for sharded RFF-KRLS (``repro``'s, the same
    numbers).

    Dominant term: the ``(D/n, D)`` P row block. Per tick each shard also
    materializes the full ``(2D+1,)`` all_reduce payload (pz ++ scattered z
    ++ partial prediction) plus its local ``(D/n,)`` slices.
    """
    d, n = num_features, n_shards
    if d % n:
        raise ValueError(f"D={d} must divide n_shards={n}")
    p_block = d * (d // n) * itemsize
    features = (input_dim + 1) * (d // n) * itemsize  # omega cols + bias
    theta = (d // n) * itemsize
    tick_payload = (2 * d + 1) * itemsize  # the one all_reduce per tick
    return {
        "p_block_bytes": p_block,
        "feature_bytes": features,
        "theta_bytes": theta,
        "tick_payload_bytes": tick_payload,
        "total_bytes": p_block + features + theta + tick_payload,
        "dense_p_bytes": d * d * itemsize,
    }


def _batch_dim_spec(mesh, batch: int) -> tuple:
    dp = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    ndev = 1
    for a in dp:
        ndev *= sizes[a]
    return (dp,) if batch >= ndev else ()


def batch_specs(mesh, *, batch: int, kind: str) -> tuple:
    """Placements for (B, S) token batches / (B,) decode tokens: the batch
    dim over the data axes, or replicated when B is under their extent
    (long_500k's B = 1)."""
    del kind
    return placements(_batch_dim_spec(mesh, batch), mesh)


def _decode_dim_specs(cfg: ModelConfig, mesh, state_shape: Any,
                      batch: int) -> Any:
    dp = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    ndev = 1
    for a in dp:
        ndev *= sizes[a]
    batch_axis = dp if batch >= ndev else None
    # DP archs keep head-structured state dims replicated over the model
    # axis; heads may not divide it anyway (qwen: 14).
    hmodel = None if cfg.preferred_parallelism == "dp" else "model"

    def rule(names, leaf):
        base_ndim = len(_shape(leaf))
        name = names[-1] if names else ""

        def wrap(*spec_dims):
            return tuple(list(spec_dims) + [None] * (base_ndim
                                                     - len(spec_dims)))

        if base_ndim == 0:
            return wrap()
        if name in ("k", "v"):  # KV cache (B, S, hkv, dh): the sequence
            return wrap(batch_axis, "model", None, None)
        if name in ("c_kv", "k_rope"):  # MLA latent cache (B, S, r)
            if batch_axis:
                return wrap(batch_axis, "model", None)
            return wrap(None, ("model",) + tuple(dp), None)  # B = 1
        if name == "s":  # RFF state (B, H, D, dv)
            if batch_axis:
                return wrap(batch_axis, hmodel, None, None)
            return wrap(None, hmodel, dp, None)
        if name == "z":  # (B, H, D)
            if batch_axis:
                return wrap(batch_axis, hmodel, None)
            return wrap(None, hmodel, dp)
        if name == "h" and base_ndim == 4:  # mamba2 (B, H, dh, N)
            if batch_axis:
                return wrap(batch_axis, None, None, None)
            return wrap(None, None, None, dp)
        if name == "h" and base_ndim == 3:  # rglru (B, Hp, hd)
            return wrap(batch_axis, hmodel, None)
        if name == "conv" and base_ndim == 4:  # rglru (B, W-1, Hp, hd)
            return wrap(batch_axis, None, hmodel, None)
        if name == "conv":  # mamba (B, W-1, C)
            return wrap(batch_axis, None, None)
        return wrap(batch_axis)

    return tree_map_with_path(rule, state_shape)


def decode_state_specs(cfg: ModelConfig, mesh, state_shape: Any,
                       batch: int) -> Any:
    """Placements for the per-layer decode-state tree (``transformer.
    decode_state_init``'s; a ``pos`` int takes all-Replicate)."""
    return tree_map_with_path(
        lambda names, leaf, spec: placements(spec, mesh), state_shape,
        _decode_dim_specs(cfg, mesh, state_shape, batch))


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Each tensor leaf of ``tree`` as a ``DTensor`` on ``mesh`` with its
    placements from ``specs`` (a tree of ``tree``'s structure, as the
    functions above return). A plain leaf is taken as the same global
    tensor on every rank and cut locally, with no collective; a DTensor
    leaf is redistributed. Non-tensor leaves pass through."""
    def one(names, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        places = spec.placements if isinstance(spec, NamedSharding) else (
            placements(spec, mesh))
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, places)
        return distribute_tensor(leaf, mesh, places, src_data_rank=None)

    return tree_map_with_path(one, tree, specs)
