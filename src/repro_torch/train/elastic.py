"""Elastic scaling: re-place a train state onto other devices or meshes.

Counterpart of ``repro/train/elastic.py``. When the healthy device set
changes, the state moves to the new topology between steps: gathered to
the host once (a DTensor through ``full_tensor``), then placed leaf by
leaf. The data is stateless in ``(seed, step)``, so training goes on with
the same global batches after a re-placement.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.optim.tree import tree_map

__all__ = ["remesh"]


def _host(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _is_placement(p) -> bool:
    return (isinstance(p, (torch.device, str)) or (
        isinstance(p, tuple) and len(p) == 2
        and isinstance(p[0], DeviceMesh)))


def _place(x, p):
    if isinstance(p, (torch.device, str)):
        return x.to(p)
    mesh, placements = p
    return distribute_tensor(x.to(mesh.device_type), mesh, list(placements))


def _remesh(node, spec):
    if _is_placement(spec):  # one placement for the whole subtree
        return tree_map(lambda x: _place(x, spec), node)
    if isinstance(node, dict):
        return {k: _remesh(v, spec[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        vals = [_remesh(v, s) for v, s in zip(node, spec, strict=True)]
        if isinstance(node, list):
            return vals
        return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
    raise ValueError(f"no placement for a leaf: {spec!r}")


def remesh(state: Any, new_placements: Any) -> Any:
    """Re-place ``state`` by ``new_placements``: a tree of ``state``'s
    structure (or a prefix of it, one placement for a whole subtree)
    whose leaves are a ``torch.device`` (or its name) or a ``(DeviceMesh,
    placements)`` pair, giving a DTensor. The state is gathered to the host
    once first."""
    return _remesh(tree_map(_host, state), new_placements)
