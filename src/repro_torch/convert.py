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
    "rff_state",
    "kv_cache",
    "to_numpy",
]


def tensor(a, *, device="cuda", dtype=None) -> torch.Tensor:
    """A contiguous copy of numpy ``a`` on ``device`` (dtype kept unless
    given)."""
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
    a = np.asarray(node)
    return tensor(a if layer is None else a[layer], device=dev)


def lm_params(params_np: dict, cfg, *, device="cuda") -> dict:
    """``repro``'s LM parameter tree (numpy leaves, ``jax.tree.map(np.asarray,
    params)``) as the port's: the same nested dicts, with the layers as a
    list under ``"blocks"``. Takes either of ``repro``'s layouts: the
    stacked ``"blocks"`` (``scan_layers=True``, a leading layer axis on
    every leaf) or ``"blocks_list"``. Leaf dtypes are kept."""
    dev = resolve_device(device)
    if "blocks" in params_np:
        layers = [_tree(params_np["blocks"], dev, i)
                  for i in range(cfg.num_layers)]
    else:
        layers = _tree(params_np["blocks_list"], dev)
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.num_layers}-layer "
                         "config")
    out = {k: _tree(v, dev) for k, v in params_np.items()
           if k not in ("blocks", "blocks_list")}
    out["blocks"] = layers
    return out


def rff_state(s, z, pos, *, device="cuda"):
    """``repro``'s ``RFFState`` (one layer: s (B, H, D, dv), z (B, H, D))
    as the port's."""
    from repro_torch.models.rff_attention import RFFState

    return RFFState(s=tensor(s, device=device), z=tensor(z, device=device),
                    pos=int(pos))


def kv_cache(k, v, pos, *, device="cuda"):
    """``repro``'s ``KVCache`` (one layer: k, v (B, S_max, Hkv, dh)) as the
    port's."""
    from repro_torch.models.attention import KVCache

    return KVCache(k=tensor(k, device=device), v=tensor(v, device=device),
                   pos=int(pos))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The reverse direction: a port tensor as a host numpy array."""
    return t.detach().cpu().numpy()
