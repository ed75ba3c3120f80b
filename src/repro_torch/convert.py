"""Carry ``repro``'s parameters and state across as numpy arrays.

Every function takes numpy arrays (``np.asarray`` of a JAX array, say) and
returns the port's objects on ``device``, so both packages can compute on
the same numbers without the port reproducing JAX's PRNG. Nothing here
imports ``repro`` or ``jax``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch import resolve_device
from repro_torch.core.bank import BankHParams
from repro_torch.core.klms import LMSState
from repro_torch.core.krls import (
    KRLS_SHARD_AXIS,
    RLSState,
    _place,
    _rows,
    krls_state_specs,
)
from repro_torch.features.base import (
    FeatureMap,
    TrigFeatures,
    trig_map,
    uniform_trig_scale,
)
from repro_torch.features.deterministic import (
    TaylorParams,
    taylor_features,
    taylor_weights,
)

__all__ = [
    "tensor",
    "trig_features",
    "feature_map",
    "bank_hparams",
    "policy_state",
    "lms_state",
    "rls_state",
    "sharded_rls_state",
    "gather",
    "gather_rls_state",
    "lm_params",
    "train_state",
    "train_state_to_numpy",
    "rff_state",
    "kv_cache",
    "mla_cache",
    "mamba2_state",
    "rglru_state",
    "decode_state",
    "to_numpy",
]


def tensor(a, *, device="cuda", dtype=None) -> torch.Tensor:
    """A contiguous copy of numpy ``a`` (or of a tensor) on ``device``
    (dtype kept unless given)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().clone()
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device)).contiguous()


def trig_features(omega, bias, scale: Optional[np.ndarray] = None, *,
                  device="cuda") -> TrigFeatures:
    """``repro``'s ``TrigFeatures`` (or ``RFF`` when ``scale`` is None,
    which takes the uniform ``sqrt(2/D)`` scale) as the port's map."""
    dev = resolve_device(device)
    omega_t = tensor(omega, device=dev)
    if scale is None:
        scale_t = uniform_trig_scale(omega_t.shape[1], omega_t.dtype, dev)
    else:
        scale_t = tensor(scale, device=dev)
    return TrigFeatures(omega=omega_t, bias=tensor(bias, device=dev),
                        scale=scale_t)


def feature_map(family: str, leaves: Sequence[np.ndarray], *,
                deterministic: bool, device="cuda") -> FeatureMap:
    """``repro``'s ``FeatureMap`` from its family and its params' numpy
    leaves (``[np.asarray(a) for a in fm.params]``): a trig family's
    ``(omega, bias, scale)``, or taylor's ``(exponents, coeff,
    inv_two_sigma_sq)``. Leaf dtypes are kept."""
    dev = resolve_device(device)
    tensors = [tensor(a, device=dev) for a in leaves]
    if family == "taylor":
        return FeatureMap(family, TaylorParams(*tensors), taylor_features,
                          taylor_weights, deterministic)
    return trig_map(family, TrigFeatures(*tensors), deterministic)


def bank_hparams(mu, beta, lam, *, device="cuda") -> BankHParams:
    """``repro``'s ``BankHParams`` (``(B,)`` numpy leaves) as the port's."""
    return BankHParams(*(tensor(a, device=device) for a in (mu, beta, lam)))


def policy_state(d: dict) -> dict:
    """``repro``'s ``SlotPolicy.state_dict()`` as plain Python values (int
    keys and counts), which the port's ``SlotPolicy.load_state`` takes."""
    ints = {k: int(d[k]) for k in ("slots", "clock", "rejects_since_resize")}
    maps = {k: {int(t): int(v) for t, v in d[k].items()}
            for k in ("last_touch", "touches", "resident")}
    return {"scorer": str(d["scorer"]), **ints, **maps,
            "free": [int(s) for s in d["free"]]}


def lms_state(theta, step, *, device="cuda") -> LMSState:
    """``repro``'s ``LMSState`` (a single filter or a bank) as the port's."""
    return LMSState(theta=tensor(theta, device=device),
                    step=tensor(step, device=device, dtype=torch.int32))


def rls_state(theta, pmat, step, *, device="cuda") -> RLSState:
    """``repro``'s ``RLSState`` (a single filter or a bank) as the port's."""
    return RLSState(theta=tensor(theta, device=device),
                    pmat=tensor(pmat, device=device),
                    step=tensor(step, device=device, dtype=torch.int32))


def sharded_rls_state(theta, pmat, step, mesh,
                      axis: str = KRLS_SHARD_AXIS) -> RLSState:
    """``repro``'s single-filter ``RLSState`` (global numpy leaves, as
    ``np.asarray`` of its sharded arrays gives them) placed on ``mesh`` as
    the port's row-sharded state: each rank keeps its rows of theta and P
    (``core.krls.krls_state_specs``)."""
    theta, pmat = np.asarray(theta), np.asarray(pmat)
    dfull = theta.shape[0]
    lo, dn = _rows(mesh, axis, dfull)
    dev = resolve_device(mesh.device_type)
    specs = krls_state_specs(axis)
    return RLSState(
        theta=_place(tensor(theta[lo:lo + dn], device=dev), mesh,
                     specs.theta, (dfull,)),
        pmat=_place(tensor(pmat[lo:lo + dn], device=dev), mesh, specs.pmat,
                    (dfull, dfull)),
        step=_place(tensor(step, device=dev, dtype=torch.int32), mesh,
                    specs.step, ()),
    )


def gather(t, group=None) -> np.ndarray:
    """A ``Shard(0)`` (or replicated) DTensor as its global numpy array on
    every rank, by one ``all_gather`` of host copies on ``group`` (default:
    the mesh's group). With NCCL ranks, pass a gloo group: host tensors
    need one, and this function picks no backend itself."""
    local = t.to_local().detach().cpu().contiguous()
    if not isinstance(t.placements[0], Shard):
        return local.numpy()
    if t.placements[0].dim != 0:
        raise ValueError(f"gather takes Shard(0) rows, not {t.placements}")
    if group is None:
        group = t.device_mesh.get_group(0)
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).numpy()


def gather_rls_state(state: RLSState, group=None) -> tuple:
    """The reverse of :func:`sharded_rls_state`: global numpy ``(theta,
    pmat, step)`` on every rank (see :func:`gather` for ``group``)."""
    return tuple(gather(a, group) for a in state)


def _tree(node, dev, layer=None):
    """A nested dict (or list) of numpy leaves as tensors on ``dev``; with
    ``layer``, every leaf is sliced at that index of its leading axis."""
    if isinstance(node, dict):
        return {k: _tree(v, dev, layer) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, dev, layer) for v in node]
    if not isinstance(node, torch.Tensor):
        node = np.asarray(node)
    return tensor(node if layer is None else node[layer], device=dev)


def lm_params(params_np: dict, cfg, *, device="cuda") -> dict:
    """``repro``'s LM parameter tree (numpy leaves, ``jax.tree.map(np.asarray,
    params)``) as the port's: the same nested dicts, with the layers (the
    hybrid's groups) as a list under ``"blocks"`` and the hybrid's extra
    recurrent blocks under ``"extra"``. Takes either of ``repro``'s layouts:
    the stacked ``"blocks"`` (``scan_layers=True``, a leading layer axis on
    every leaf) or ``"blocks_list"``, or the port's own (``"blocks"`` a
    list); leaves may be tensors. Leaf dtypes are kept."""
    from repro_torch.models.transformer import num_scan_layers

    dev = resolve_device(device)
    n_scan, n_extra = num_scan_layers(cfg)
    if isinstance(params_np.get("blocks"), list):  # the port's own layout
        layers = _tree(params_np["blocks"], dev)
    elif "blocks" in params_np:
        layers = [_tree(params_np["blocks"], dev, i) for i in range(n_scan)]
    else:
        layers = _tree(params_np["blocks_list"], dev)
    extra = params_np.get("extra", [])
    if len(layers) != n_scan or len(extra) != n_extra:
        raise ValueError(f"{len(layers)} layers and {len(extra)} extra blocks "
                         f"for a config of {n_scan} and {n_extra}")
    out = {k: _tree(v, dev) for k, v in params_np.items()
           if k not in ("blocks", "blocks_list")}
    out["blocks"] = layers
    return out


def train_state(state_np: dict, cfg, *, device="cuda") -> dict:
    """``repro``'s train state ``{"params", "opt": AdamWState(m, v, count),
    "step"}`` (numpy leaves; either of its layouts, or the port's) as the
    port's: the params and both moments through :func:`lm_params`, the
    count and step as 0-d int32 tensors. Leaf dtypes are kept."""
    from repro_torch.optim.optimizers import AdamWState

    dev = resolve_device(device)
    m, v, count = state_np["opt"]
    return {"params": lm_params(state_np["params"], cfg, device=dev),
            "opt": AdamWState(m=lm_params(m, cfg, device=dev),
                              v=lm_params(v, cfg, device=dev),
                              count=tensor(count, device=dev,
                                           dtype=torch.int32)),
            "step": tensor(state_np["step"], device=dev, dtype=torch.int32)}


def _host(tree):
    """A tree of tensors as numpy leaves (bf16 widened to f32, exactly)."""
    from repro_torch.optim.tree import tree_map

    return tree_map(lambda t: to_numpy(
        t.float() if t.dtype == torch.bfloat16 else t), tree)


def _repro_params(params: dict, cfg) -> dict:
    """The port's params in ``repro``'s layout for ``cfg``: the layers
    stacked under ``"blocks"`` when ``cfg.scan_layers``, else listed under
    ``"blocks_list"``; numpy leaves."""
    out = {k: _host(v) for k, v in params.items() if k != "blocks"}
    layers = [_host(b) for b in params["blocks"]]
    if not cfg.scan_layers:
        out["blocks_list"] = layers
        return out

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    out["blocks"] = stack(*layers)
    return out


def train_state_to_numpy(state: dict, cfg) -> dict:
    """The reverse of :func:`train_state`: the port's train state in
    ``repro``'s layout with numpy leaves (bf16 leaves widened to f32, which
    is exact), ``opt`` the port's ``AdamWState``."""
    from repro_torch.optim.optimizers import AdamWState

    opt = state["opt"]
    return {"params": _repro_params(state["params"], cfg),
            "opt": AdamWState(m=_repro_params(opt.m, cfg),
                              v=_repro_params(opt.v, cfg),
                              count=to_numpy(opt.count)),
            "step": to_numpy(state["step"])}


def rff_state(s, z, pos, *, device="cuda"):
    """``repro``'s ``RFFState`` (one layer: s (B, H, D, dv), z (B, H, D))
    as the port's."""
    from repro_torch.models.rff_attention import RFFState

    return RFFState(s=tensor(s, device=device), z=tensor(z, device=device),
                    pos=int(pos))


def kv_cache(k, v, pos, *, device="cuda"):
    """``repro``'s ``KVCache`` (one layer: k, v (B, S_max, Hkv, dh)) as the
    port's. The hybrid's ring cache is the same type: its k and v hold
    ``min(local_window, max_len)`` slots and ``pos`` counts every token
    seen, the next write going to slot ``pos % slots``."""
    from repro_torch.models.attention import KVCache

    return KVCache(k=tensor(k, device=device), v=tensor(v, device=device),
                   pos=int(pos))


def mla_cache(c_kv, k_rope, pos, *, device="cuda"):
    """``repro``'s ``MLACache`` (one layer: c_kv (B, S_max, r), k_rope
    (B, S_max, dr)) as the port's."""
    from repro_torch.models.attention import MLACache

    return MLACache(c_kv=tensor(c_kv, device=device),
                    k_rope=tensor(k_rope, device=device), pos=int(pos))


def mamba2_state(h, conv, pos, *, device="cuda"):
    """``repro``'s ``Mamba2State`` (one layer: h (B, H, dh, N), conv (B,
    W-1, conv_dim)) as the port's."""
    from repro_torch.models.ssm import Mamba2State

    return Mamba2State(h=tensor(h, device=device),
                       conv=tensor(conv, device=device), pos=int(pos))


def rglru_state(h, conv, pos, *, device="cuda"):
    """``repro``'s ``RGLRUState`` (one block: h (B, Hp, hd), conv (B, W-1,
    Hp, hd)) as the port's."""
    from repro_torch.models.rglru import RGLRUState

    return RGLRUState(h=tensor(h, device=device),
                      conv=tensor(conv, device=device), pos=int(pos))


def _block_state(node, cfg, dev):
    """One entry of ``repro``'s state stack (numpy leaves) as the port's."""
    if cfg.mixer == "mamba2":
        return mamba2_state(*node, device=dev)
    if cfg.mixer == "rglru_hybrid":
        return {"rec1": rglru_state(*node["rec1"], device=dev),
                "rec2": rglru_state(*node["rec2"], device=dev),
                "attn": kv_cache(*node["attn"], device=dev)}
    if cfg.attention == "rff":
        return rff_state(*node, device=dev)
    if cfg.attention == "mla":
        return mla_cache(*node, device=dev)
    return kv_cache(*node, device=dev)


def _layer(node, i):
    """Entry ``i`` of a stacked state tree (every array sliced on its
    leading axis; a tuple keeps its type)."""
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    if isinstance(node, tuple):
        return type(node)(*(_layer(v, i) for v in node))
    return np.asarray(node)[i]


def decode_state(state_np: dict, cfg, *, device="cuda") -> dict:
    """``repro``'s whole decode state (``decode_state_init`` or a later
    state, numpy leaves) as the port's ``{"stack", "extra"}``. Takes the
    stacked layout (``scan_layers=True``) or the list."""
    from repro_torch.models.transformer import num_scan_layers

    dev = resolve_device(device)
    stack = state_np["stack"]
    if not isinstance(stack, list):
        stack = [_layer(stack, i) for i in range(num_scan_layers(cfg)[0])]
    return {"stack": [_block_state(node, cfg, dev) for node in stack],
            "extra": [rglru_state(*node, device=dev)
                      for node in state_np["extra"]]}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The reverse direction: a port tensor as a host numpy array."""
    return t.detach().cpu().numpy()
