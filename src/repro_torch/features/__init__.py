"""Feature maps: the affine-trig contract (``base``) and the Monte-Carlo
families (``random``)."""
from repro_torch.features.base import (
    TrigFeatures,
    as_trig,
    as_trig_or_none,
    featurize,
    trig_features,
    uniform_trig_scale,
)
from repro_torch.features.random import orf_map, rff_map
