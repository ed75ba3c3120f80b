"""Monte-Carlo trig families: iid RFF and orthogonal random features.

Counterpart of ``repro/features/random.py``. Both sample through
:func:`repro_torch.core.rff.sample_rff`, canonicalize to
:class:`~repro_torch.features.base.TrigFeatures` with the uniform
``sqrt(2/D)`` scale and return it wrapped as a
:class:`~repro_torch.features.base.FeatureMap`, as ``repro`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.rff import sample_rff
from repro_torch.features.base import FeatureMap, trig_from_rff, trig_map

__all__ = ["rff_map", "orf_map"]


def rff_map(generator: torch.Generator, input_dim: int, num_features: int,
            sigma: float, dtype=torch.float32, device="cuda") -> FeatureMap:
    """The paper's Monte-Carlo RFF map for ``exp(-||u||^2 / (2 sigma^2))``."""
    rff = sample_rff(generator, input_dim, num_features, sigma, dtype,
                     device=device)
    return trig_map("rff", trig_from_rff(rff), deterministic=False)


def orf_map(generator: torch.Generator, input_dim: int, num_features: int,
            sigma: float, dtype=torch.float32, device="cuda") -> FeatureMap:
    """Orthogonal random features: QR-orthogonalized blocks, chi norms."""
    rff = sample_rff(generator, input_dim, num_features, sigma, dtype,
                     orthogonal=True, device=device)
    return trig_map("orf", trig_from_rff(rff), deterministic=False)
