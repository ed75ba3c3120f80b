"""Wrapper of the fused feature-map kernel (``csrc/rff_features.cu``).

``rff_features`` replaces
``repro/kernels/rff_features.py::rff_features_pallas``: ``s * cos(x W +
b)`` for a block of rows in one launch, at f32 or under the bf16 contract
of ``kernels/ref.py`` (bf16 operands, f32 accumulation, bf16 output). The
wrapper checks its inputs, allocates the output, launches on the current
stream, raises on a non-zero ``cudaError_t`` and counts its launches in
``.launches``. CPU tensors are refused (``kernels/ops.py`` routes them to
the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import canon_precision, default_scale
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_features_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, b, s, out, M, d, D, bf16, stream
    "rff_features": (_P,) * 5 + (_I,) * 4 + (_P,),
    "rff_features_error_string": (_I,),
}


def _lib():
    lib = _build.load("rff_features", _SIGNATURES)
    lib.rff_features_error_string.restype = ctypes.c_char_p
    return lib


def rff_features_cuda(x, w, b, s=None, precision=None):
    """Feature block on the card: x (M, d), shared w (d, D), b (D,), s (D,)
    (None = sqrt(2/D)) -> z (M, D), f32, or bf16 under
    ``precision="bf16"``."""
    bf16 = canon_precision(precision) == "bf16"
    if x.device.type != "cuda":
        raise ValueError(
            "the CUDA feature kernel takes CUDA tensors; use mode='ref' (or "
            f"'auto') for tensors on {x.device}"
        )
    device = x.device
    if x.ndim != 2:
        raise ValueError(f"x must be (M, d), got shape {tuple(x.shape)}")
    m, d = x.shape
    dfeat = w.shape[-1]
    if s is None:
        s = default_scale(dfeat, device=device)
    for name, t, shape in (("x", x, (m, d)), ("w", w, (d, dfeat)),
                           ("b", b, (dfeat,)), ("s", s, (dfeat,))):
        _check(name, t, shape, device)
    if d < 1 or dfeat < 1:
        raise ValueError(f"empty feature map: d={d}, D={dfeat}")
    out = torch.empty((m, dfeat), device=device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    if m == 0:
        return out
    lib = _lib()
    code = lib.rff_features(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
        out.data_ptr(), m, d, dfeat, int(bf16),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if code:
        msg = lib.rff_features_error_string(code).decode()
        raise RuntimeError(f"rff_features failed: cudaError {code} ({msg})")
    rff_features_cuda.launches += 1
    return out


rff_features_cuda.launches = 0
