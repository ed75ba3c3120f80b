"""The affine-trig feature contract the kernels consume.

Counterpart of ``repro/features/base.py``. Every trig family reduces to

    z(x) = scale * cos(x @ omega + bias),   scale per feature (D,),

held as :class:`TrigFeatures`. This slice ports the Monte-Carlo families
(``features/random.py``); their maps are plain :class:`TrigFeatures`. The
generic ``FeatureMap`` wrapper arrives with the deterministic and
non-trig families (ROADMAP §1 item 2).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core.rff import RFF, rff_features
from repro_torch.kernels.ref import default_scale

__all__ = [
    "TrigFeatures",
    "FeatureLike",
    "uniform_trig_scale",
    "trig_from_rff",
    "trig_features",
    "featurize",
    "as_trig",
    "as_trig_or_none",
    "num_features",
    "input_dim",
    "feature_dtype",
]


class TrigFeatures(NamedTuple):
    """Canonical affine-trig parameters: ``omega (d, D)``, ``bias (D,)``,
    ``scale (D,)``."""

    omega: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self.omega.shape[0]

    @property
    def num_features(self) -> int:
        return self.omega.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.omega.dtype

    @property
    def device(self) -> torch.device:
        return self.omega.device

    def to(self, device) -> "TrigFeatures":
        """The same map with every tensor on ``device`` (contiguous)."""
        return TrigFeatures(
            *(t.to(device).contiguous() for t in (self.omega, self.bias,
                                                  self.scale))
        )


FeatureLike = Union[TrigFeatures, RFF]


def uniform_trig_scale(num_features: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """The Monte-Carlo ``sqrt(2/D)`` scale as a ``(D,)`` tensor, computed
    exactly like ``repro``'s (f32 ``2/D``, then an f32 root): for about 13%
    of D the f64 root cast to f32 differs by 1 ulp, and canonicalizing an
    :class:`RFF` must change nothing numerically."""
    return default_scale(num_features, dtype, device)


def trig_from_rff(rff: RFF) -> TrigFeatures:
    """Canonicalize the paper's RFF struct: uniform ``sqrt(2/D)`` scale."""
    return TrigFeatures(
        omega=rff.omega,
        bias=rff.bias,
        scale=uniform_trig_scale(
            rff.num_features, rff.omega.dtype, rff.omega.device
        ),
    )


def trig_features(tf: TrigFeatures, x: torch.Tensor) -> torch.Tensor:
    """``z(x) = scale * cos(x @ omega + bias)`` — inputs ``(..., d)``."""
    proj = x @ tf.omega + tf.bias
    return tf.scale.to(proj.dtype) * torch.cos(proj)


def featurize(fm: FeatureLike, x: torch.Tensor) -> torch.Tensor:
    """Feature map ``(..., d) -> (..., D)`` for either parameter struct."""
    if isinstance(fm, TrigFeatures):
        return trig_features(fm, x)
    if isinstance(fm, RFF):
        return rff_features(fm, x)
    raise TypeError(f"not a feature map: {type(fm).__name__}")


def as_trig_or_none(fm: FeatureLike) -> Optional[TrigFeatures]:
    """Canonical ``(W, b, scale)`` form, or None for a non-trig family
    (none is ported yet)."""
    if isinstance(fm, TrigFeatures):
        return fm
    if isinstance(fm, RFF):
        return trig_from_rff(fm)
    raise TypeError(f"not a feature map: {type(fm).__name__}")


def as_trig(fm: FeatureLike) -> TrigFeatures:
    """Canonical trig form; raises for a family without one."""
    tf = as_trig_or_none(fm)
    if tf is None:
        raise TypeError(
            f"feature family {type(fm).__name__!r} has no affine-trig form"
        )
    return tf


def num_features(fm: FeatureLike) -> int:
    return fm.num_features


def input_dim(fm: FeatureLike) -> int:
    return fm.input_dim


def feature_dtype(fm: FeatureLike) -> torch.dtype:
    """Working dtype of a feature map."""
    return fm.omega.dtype
