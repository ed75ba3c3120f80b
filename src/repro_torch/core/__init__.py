"""Core library: the paper's learners as PyTorch modules.

RFF feature maps (``rff``), RFF-KLMS (``klms``), RFF-KRLS (``krls``), the
paper's baselines QKLMS (``qklms``) and Engel's ALD-KRLS (``krls_ald``),
the convergence theory oracles (``theory``), the Monte-Carlo drivers
(``adaptive``), the diffusion-distributed variant (``distributed``), the
``OnlineLearner`` interface (``learner``), the filter bank with its
generic and fused tiers (``bank``), and RFF-KRLS with P row-sharded over a
``torch.distributed`` mesh (``krls``'s second half).
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
    KRLS_SHARD_AXIS,
    RLSState,
    krls_feature_specs,
    krls_state_specs,
    make_sharded_krls_predict,
    make_sharded_krls_step,
    rff_krls_init,
    rff_krls_run,
    rff_krls_step,
    shard_krls_rff,
    sharded_krls_init,
    sharded_krls_run,
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
    sharded_krls_learner,
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
from repro_torch.core import theory, adaptive, distributed

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
    "KRLS_SHARD_AXIS",
    "krls_state_specs",
    "krls_feature_specs",
    "shard_krls_rff",
    "sharded_krls_init",
    "sharded_krls_run",
    "make_sharded_krls_step",
    "make_sharded_krls_predict",
    "sharded_krls_learner",
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
    "distributed",
]
