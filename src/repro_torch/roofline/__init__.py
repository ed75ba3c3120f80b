"""Roofline terms from a per-rank cost (``repro.roofline``'s names), with
the port's counter of a run under a fake process group."""
from repro_torch.roofline.analysis import (
    HW,
    HloCost,
    RooflineTerms,
    parse_hlo_cost,
    roofline_terms,
)
from repro_torch.roofline.counter import CostCounter

__all__ = ["HW", "HloCost", "RooflineTerms", "parse_hlo_cost",
           "roofline_terms", "CostCounter"]
