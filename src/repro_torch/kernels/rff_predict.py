"""Wrapper of the fused predict-only bank kernel (``csrc/bank_predict.cu``).

``bank_predict`` replaces
``repro/kernels/rff_predict.py::rff_bank_predict_pallas``: a ``(B, Q, d)``
query block per tenant against a read-only ``theta (B, D)`` in one launch,
at f32 or under the bf16 read-path contract of ``kernels/ref.py``. The
wrapper checks its inputs, allocates the output, launches on the current
stream, raises on a non-zero ``cudaError_t`` and counts its launches in
``.launches``. CPU tensors are refused (``kernels/ops.py`` routes them to
the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import predict_workspace_bytes
from repro_torch.kernels.ref import canon_precision, default_scale
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_bank_predict_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # theta, xq, w, b, s, out, ws, ws_bytes, B, Q, d, D, bf16, stream
    "bank_predict": (_P,) * 7 + (ctypes.c_longlong,) + (_I,) * 5 + (_P,),
    "bank_predict_error_string": (_I,),
}


def _lib():
    lib = _build.load("bank_predict", _SIGNATURES)
    lib.bank_predict_error_string.restype = ctypes.c_char_p
    return lib


def rff_bank_predict_cuda(theta, xq, w, b, s=None, *, precision=None):
    """Fused read path on the card: theta (B, D), xq (B, Q, d), shared
    w (d, D), b (D,), s (D,) (None = sqrt(2/D)) -> predictions (B, Q).
    The operands are packed into a workspace first; then a thread block
    owns 128 of the B Q (tenant, query) rows and walks all of D (f32 on
    the CUDA cores; bf16 on the tensor cores). ``.launches`` counts one
    per call."""
    bf16 = canon_precision(precision) == "bf16"
    if theta.device.type != "cuda":
        raise ValueError(
            "the CUDA predict kernel takes CUDA tensors; use mode='ref' (or "
            f"'auto') for tensors on {theta.device}"
        )
    device = theta.device
    bsz, qlen, d = xq.shape
    dfeat = theta.shape[-1]
    if s is None:
        s = default_scale(dfeat, device=device)
    for name, t, shape in (
        ("theta", theta, (bsz, dfeat)), ("xq", xq, (bsz, qlen, d)),
        ("w", w, (d, dfeat)), ("b", b, (dfeat,)), ("s", s, (dfeat,)),
    ):
        _check(name, t, shape, device)
    if bsz * qlen > 2 ** 31 - 129 or bsz * dfeat > 2 ** 31 - 1:
        raise ValueError(f"B={bsz}, Q={qlen}, D={dfeat}: past the read "
                         "kernel's 2^31 rows and theta entries")
    out = torch.empty((bsz, qlen), dtype=torch.float32, device=device)
    if bsz == 0 or qlen == 0:
        return out
    ws = torch.empty(predict_workspace_bytes(bsz * qlen, d, dfeat, bf16),
                     dtype=torch.uint8, device=device)
    lib = _lib()
    code = lib.bank_predict(
        theta.data_ptr(), xq.data_ptr(), w.data_ptr(), b.data_ptr(),
        s.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), bsz, qlen,
        d, dfeat, int(bf16), torch.cuda.current_stream(device).cuda_stream,
    )
    if code:
        msg = lib.bank_predict_error_string(code).decode()
        raise RuntimeError(f"bank_predict failed: cudaError {code} ({msg})")
    rff_bank_predict_cuda.launches += 1
    return out


rff_bank_predict_cuda.launches = 0
