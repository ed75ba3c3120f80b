"""Kernels of the port: plain PyTorch oracles (``ref``), the CUDA kernels'
wrappers (``rff_klms_step``, ``rff_krls_step``, ``rff_predict``,
``rff_features``, ``rff_scan``, ``rff_attention``, ``flash_attention``,
built by ``_build``) and the ``mode=`` dispatch (``ops``).

The package exports ``repro.kernels``' names. As there, the attributes
``rff_features``, ``rff_attention`` and ``flash_attention`` are the ops,
which shadow the submodules of the same names: import a submodule by its
path (``from repro_torch.kernels.rff_features import ...``).
"""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunking import default_chunk_t
from repro_torch.kernels.ops import (
    flash_attention,
    rff_attention,
    rff_attention_decode,
    rff_bank_predict,
    rff_features,
    rff_klms_bank_chunk,
    rff_klms_bank_step,
    rff_krls_bank_chunk,
    rff_krls_bank_step,
)

__all__ = [
    "ops",
    "ref",
    "default_chunk_t",
    "rff_features",
    "rff_bank_predict",
    "rff_klms_bank_step",
    "rff_klms_bank_chunk",
    "rff_krls_bank_step",
    "rff_krls_bank_chunk",
    "rff_attention",
    "rff_attention_decode",
    "flash_attention",
]
