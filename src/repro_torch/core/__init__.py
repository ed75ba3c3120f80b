"""Core library: the paper's learners as PyTorch modules.

RFF feature maps (``rff``), RFF-KLMS (``klms``), RFF-KRLS (``krls``), the
paper's baselines QKLMS (``qklms``) and Engel's ALD-KRLS (``krls_ald``),
the convergence theory oracles (``theory``), the Monte-Carlo drivers
(``adaptive``), the ``OnlineLearner`` interface (``learner``) and the
filter bank with its generic and fused tiers (``bank``). The sharded KRLS
and the diffusion variants are ROADMAP §1 item 10.
"""
from repro_torch.core.rff import (
    RFF,
    sample_rff,
    rff_features,
    kernel_estimate,
    gaussian_kernel,
    sample_prf,
    positive_random_features,
)
from repro_torch.core.klms import (
    LMSState,
    StepOut,
    rff_klms_init,
    rff_klms_step,
    rff_klms_run,
    rff_klms_batch_step,
)
from repro_torch.core.krls import (
    RLSState,
    rff_krls_init,
    rff_krls_step,
    rff_krls_run,
)
from repro_torch.core.qklms import (
    QKLMSState,
    qklms_init,
    qklms_step,
    qklms_run,
)
from repro_torch.core.krls_ald import (
    ALDKRLSState,
    ald_krls_init,
    ald_krls_step,
    ald_krls_run,
)
from repro_torch.core.learner import (
    OnlineLearner,
    klms_learner,
    nklms_learner,
    krls_learner,
    qklms_learner,
    ald_krls_learner,
)
from repro_torch.core.bank import (
    bank_init,
    bank_step,
    bank_run,
    bank_predict,
    klms_bank_init,
    klms_bank_step,
    klms_bank_run,
    krls_bank_init,
    krls_bank_step,
    krls_bank_run,
    mixed_klms_bank_run,
    mixed_krls_bank_run,
    stack_feature_maps,
)
from repro_torch.core import theory, adaptive

__all__ = [
    "OnlineLearner",
    "klms_learner",
    "nklms_learner",
    "krls_learner",
    "qklms_learner",
    "ald_krls_learner",
    "bank_init",
    "bank_step",
    "bank_run",
    "bank_predict",
    "klms_bank_init",
    "klms_bank_step",
    "klms_bank_run",
    "krls_bank_init",
    "krls_bank_step",
    "krls_bank_run",
    "mixed_klms_bank_run",
    "mixed_krls_bank_run",
    "stack_feature_maps",
    "RFF",
    "sample_rff",
    "rff_features",
    "kernel_estimate",
    "gaussian_kernel",
    "sample_prf",
    "positive_random_features",
    "LMSState",
    "StepOut",
    "rff_klms_init",
    "rff_klms_step",
    "rff_klms_run",
    "rff_klms_batch_step",
    "RLSState",
    "rff_krls_init",
    "rff_krls_step",
    "rff_krls_run",
    "QKLMSState",
    "qklms_init",
    "qklms_step",
    "qklms_run",
    "ALDKRLSState",
    "ald_krls_init",
    "ald_krls_step",
    "ald_krls_run",
    "theory",
    "adaptive",
]
