"""Device meshes on ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``'s KRLS mesh: the 1-D mesh over
the KRLS shard axis (the P row-block partition). A JAX ``Mesh`` axis
becomes a 1-D ``DeviceMesh`` dim of the same name, built on the process
group the caller initialized: the caller names the backend (NCCL for one
rank a card; gloo, which also takes CUDA tensors for ``all_reduce``, for
several ranks on one card or on the CPU), and nothing here picks one. The
LM meshes (``make_production_mesh``, ``data_axes``) wait for the LM
stack's port.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.krls import KRLS_SHARD_AXIS

__all__ = ["make_krls_mesh", "KRLS_SHARD_AXIS"]


def make_krls_mesh(n_shards: Optional[int] = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the KRLS shard axis on the initialized default process
    group, one shard a rank. ``n_shards`` defaults to the world size and
    must equal it (``repro`` may take fewer of its devices; a rank here is
    a process that must take part). Raises when no process group is
    initialized."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_krls_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, ...) first")
    world = dist.get_world_size()
    if n_shards is not None and n_shards != world:
        raise ValueError(
            f"n_shards={n_shards} must equal the world size ({world}): one "
            "shard a rank")
    return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                 mesh_dim_names=(KRLS_SHARD_AXIS,))
