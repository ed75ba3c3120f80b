"""Launchers: production meshes, sharding rules, the dry-run, the train and
serve command lines."""
from repro_torch.launch.mesh import data_axes, make_production_mesh

__all__ = ["make_production_mesh", "data_axes"]
