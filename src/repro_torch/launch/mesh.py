"""Device meshes on ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``. A JAX ``Mesh`` becomes a
``DeviceMesh`` with the same axis names, built on the process group the
caller initialized: the caller names the backend (NCCL for one rank a card;
gloo, which also takes CUDA tensors for ``all_reduce``, for several ranks on
one card or on the CPU; the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg`` for the dry-run), and
nothing here picks one.

* The production meshes: single pod (16, 16) = 256 ranks over
  ``("data", "model")``; multi-pod (2, 16, 16) = 512 ranks over
  ``("pod", "data", "model")``, the ``"pod"`` axis an outer data/FSDP axis.
* The KRLS mesh: 1-D over the KRLS shard axis (the P row-block partition).

A rank is a process that must take part, so each mesh needs a world of its
size exactly, where ``repro`` may take fewer of its devices.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.krls import KRLS_SHARD_AXIS

__all__ = [
    "make_production_mesh",
    "make_krls_mesh",
    "make_mesh",
    "data_axes",
    "DP_AXES",
    "MODEL_AXIS",
    "KRLS_SHARD_AXIS",
]

MODEL_AXIS = "model"


def _world(caller: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{caller} needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, ...) first")
    return dist.get_world_size()


def make_mesh(shape: tuple, axes: tuple, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` on the
    initialized default process group, ranks laid out row-major (the last
    axis minor, as ``jax.make_mesh``). Raises without a process group and
    when the world size is not the mesh's size."""
    size = 1
    for n in shape:
        size *= n
    world = _world("make_mesh")
    if world != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks; the "
                         f"world has {world}")
    return DeviceMesh(device_type, torch.arange(size).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ``("data", "model")``, or with ``multi_pod`` (2, 16,
    16) over ``("pod", "data", "model")``, on the initialized default
    process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_krls_mesh(n_shards: Optional[int] = None,
                   device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the KRLS shard axis on the initialized default process
    group, one shard a rank. ``n_shards`` defaults to the world size and
    must equal it (``repro`` may take fewer of its devices; a rank here is
    a process that must take part). Raises when no process group is
    initialized."""
    world = _world("make_krls_mesh")
    if n_shards is not None and n_shards != world:
        raise ValueError(
            f"n_shards={n_shards} must equal the world size ({world}): one "
            "shard a rank")
    return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                 mesh_dim_names=(KRLS_SHARD_AXIS,))


def _axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or a
    mesh-like object's ``axis_names``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def data_axes(mesh) -> tuple[str, ...]:
    """All data-parallel-like axes (everything except the model axis)."""
    return tuple(a for a in _axis_names(mesh) if a != MODEL_AXIS)


DP_AXES = data_axes  # alias
