"""Wrapper of the fused predict-only bank kernel (``csrc/bank_predict.cu``).

``bank_predict`` replaces
``repro/kernels/rff_predict.py::rff_bank_predict_pallas``: a ``(B, Q, d)``
query block per tenant against a read-only ``theta (B, D)`` in one launch,
at f32 or under the bf16 read-path contract of ``kernels/ref.py``. The
wrapper checks its inputs, allocates the output, launches on the current
stream, raises on a non-zero ``cudaError_t`` and counts its calls in
``.launches`` and per route in ``.route_launches``. CPU tensors are
refused (``kernels/ops.py`` routes them to the plain version).

Two routes (``chunking.PREDICT_ROUTES``), picked by
``chunking.predict_route``: "bank" (a block owns 128 rows and walks all of
D) and, where that gives too few blocks to fill the card, "few" (z formed
by (row tile x column tile) blocks, then a reduce launch that runs the
bank route's chain for each row). A row's bits are the same on both and
whatever B. ``_route=`` forces one (any other name raises, before the
device check).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import (
    PREDICT_ROUTES,
    predict_route,
    predict_workspace_bytes,
)
from repro_torch.kernels.ref import canon_precision, default_scale
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_bank_predict_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# theta, xq, w, b, s, out, ws, ws_bytes, B, Q, d, D, bf16, stream
_ENTRY = (_P,) * 7 + (ctypes.c_longlong,) + (_I,) * 5 + (_P,)
_SIGNATURES = {
    "bank_predict": _ENTRY,
    "bank_predict_few": _ENTRY,
    "bank_predict_error_string": (_I,),
}


def _lib():
    lib = _build.load("bank_predict", _SIGNATURES)
    lib.bank_predict_error_string.restype = ctypes.c_char_p
    return lib


def rff_bank_predict_cuda(theta, xq, w, b, s=None, *, precision=None,
                          _route=None):
    """Fused read path on the card: theta (B, D), xq (B, Q, d), shared
    w (d, D), b (D,), s (D,) (None = sqrt(2/D)) -> predictions (B, Q).
    The operands are packed into a workspace first; then on the "bank"
    route a thread block owns 128 of the B Q (tenant, query) rows and walks
    all of D (f32 on the CUDA cores; bf16 on the tensor cores), on the
    "few" route blocks of (rows, 128 columns) form z and a reduce launch
    sums each row in the bank route's order. ``.launches`` counts one per
    call."""
    bf16 = canon_precision(precision) == "bf16"
    if _route is not None and _route not in PREDICT_ROUTES:
        raise ValueError(f"unknown read route {_route!r}; use one of "
                         f"{PREDICT_ROUTES}")
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
    route = _route or predict_route(bsz * qlen, dfeat)
    ws = torch.empty(
        predict_workspace_bytes(bsz * qlen, d, dfeat, bf16, route),
        dtype=torch.uint8, device=device)
    lib = _lib()
    entry = lib.bank_predict_few if route == "few" else lib.bank_predict
    code = entry(
        theta.data_ptr(), xq.data_ptr(), w.data_ptr(), b.data_ptr(),
        s.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), bsz, qlen,
        d, dfeat, int(bf16), torch.cuda.current_stream(device).cuda_stream,
    )
    if code:
        msg = lib.bank_predict_error_string(code).decode()
        raise RuntimeError(f"bank_predict ({route} route) failed: "
                           f"cudaError {code} ({msg})")
    rff_bank_predict_cuda.launches += 1
    rff_bank_predict_cuda.route_launches[route] += 1
    return out


rff_bank_predict_cuda.launches = 0
rff_bank_predict_cuda.route_launches = dict.fromkeys(PREDICT_ROUTES, 0)
