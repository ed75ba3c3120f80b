"""The paper's own experiment configurations (§5, §6) as named presets.

The port's copy of ``repro/configs/paper_rff.py``, field by field (the
port imports nothing of ``repro``).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PaperExperiment", "EXPERIMENTS"]


@dataclass(frozen=True)
class PaperExperiment:
    name: str
    num_samples: int
    runs: int  # paper's Monte-Carlo run count
    sigma: float  # Gaussian kernel parameter
    mu: float  # step size
    rff_dim: int  # D for RFFKLMS
    qklms_eps: float  # quantization size for QKLMS
    qklms_capacity: int  # dictionary buffer bound
    # KRLS (example 2 only, §6)
    krls_lambda: float = 1e-4
    krls_beta: float = 0.9995
    krls_nu: float = 5e-4


EXPERIMENTS: dict[str, PaperExperiment] = {
    # §5.1 Fig 1: linear kernel expansion, steady state vs theory
    "example1": PaperExperiment(
        name="example1", num_samples=5000, runs=100, sigma=5.0, mu=1.0,
        rff_dim=1000, qklms_eps=0.0, qklms_capacity=0,
    ),
    # §5.2 Fig 2a/2b: nonlinear Wiener model (9)
    "example2": PaperExperiment(
        name="example2", num_samples=15000, runs=1000, sigma=5.0, mu=1.0,
        rff_dim=300, qklms_eps=5.0, qklms_capacity=256,
    ),
    # §5.3 Fig 3a: chaotic series 1
    "example3": PaperExperiment(
        name="example3", num_samples=500, runs=1000, sigma=0.05, mu=1.0,
        rff_dim=100, qklms_eps=0.01, qklms_capacity=64,
    ),
    # §5.4 Fig 3b: chaotic series 2
    "example4": PaperExperiment(
        name="example4", num_samples=1000, runs=1000, sigma=0.05, mu=1.0,
        rff_dim=100, qklms_eps=0.01, qklms_capacity=128,
    ),
}
