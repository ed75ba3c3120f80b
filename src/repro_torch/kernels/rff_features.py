"""Wrapper of the fused feature-map kernel (``csrc/rff_features.cu``).

``rff_features`` replaces
``repro/kernels/rff_features.py::rff_features_pallas``: ``s * cos(x W +
b)`` for a block of rows in one C call (a packing launch, then the feature
tile of ``csrc/feature_tile.cuh``), at f32 or under the bf16 contract of
``kernels/ref.py`` (bf16 operands, f32 accumulation, bf16 output). The
wrapper checks its inputs, allocates the output and the packed operands'
workspace, launches on the current stream, raises on a non-zero
``cudaError_t`` and counts its calls in ``.launches``. CPU tensors are
refused (``kernels/ops.py`` routes them to the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import (
    feature_tile_grid,
    feature_tile_pack_floats,
)
from repro_torch.kernels.ref import canon_precision, default_scale
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_features_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, w, b, s, out, ws, ws_floats, M, d, D, bf16, rows, stream
    "rff_features": (_P,) * 6 + (_L,) + (_I,) * 5 + (_P,),
    "rff_features_error_string": (_I,),
}
# The tile's rows a test may force (``_rows=``); None takes the plan's.
TILE_ROWS = (128, 32)


def _lib():
    lib = _build.load("rff_features", _SIGNATURES)
    lib.rff_features_error_string.restype = ctypes.c_char_p
    return lib


def rff_features_cuda(x, w, b, s=None, precision=None, *, _rows=None):
    """Feature block on the card: x (M, d), shared w (d, D), b (D,), s (D,)
    (None = sqrt(2/D)) -> z (M, D), f32, or bf16 under
    ``precision="bf16"``. A row's bits depend on its x row and on W, b, s
    alone: not on M, nor on the tile's rows (128 where those tiles fill a
    wave of the card, else 32; the tests force one with the private
    ``_rows=``)."""
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
    if _rows is not None and _rows not in TILE_ROWS:
        raise ValueError(f"_rows={_rows}: the tile takes {TILE_ROWS}")
    return launch(x, w, b, s, bf16,
                  torch.cuda.current_stream(device).cuda_stream, _rows)


def launch(x, w, b, s, bf16: bool, stream: int, rows=None, ws_ptr=None):
    """The C call on checked inputs (x (..., d) with M rows, w (d, D), b, s
    (D,), all f32, contiguous, on one card; ``stream`` the raw CUDA
    stream): allocates z (M, D) and, unless ``ws_ptr`` (the address of at
    least ``feature_tile_pack_floats(M, d, D)`` floats, 16-byte aligned,
    that the caller keeps allocated) is given, the packed operands'
    workspace, launches and counts the launch.
    ``rff_features_cuda`` checks first; the element wrappers, which check
    the same tensors themselves, call it directly."""
    d = x.shape[-1]
    m = x.numel() // d
    dfeat = w.shape[-1]
    dtype = torch.bfloat16 if bf16 else torch.float32
    out = torch.empty((m, dfeat), device=x.device, dtype=dtype)
    if m == 0:
        return out
    feature_tile_grid(m, dfeat)
    pk = feature_tile_pack_floats(m, d, dfeat)
    if ws_ptr is None:
        ws = torch.empty(pk, device=x.device, dtype=torch.float32)
        ws_ptr = ws.data_ptr()
    lib = _lib()
    code = lib.rff_features(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
        out.data_ptr(), ws_ptr, pk, m, d, dfeat, int(bf16), rows or 0, stream,
    )
    if code:
        msg = lib.rff_features_error_string(code).decode()
        raise RuntimeError(f"rff_features failed: cudaError {code} ({msg})")
    rff_features_cuda.launches += 1
    return out


rff_features_cuda.launches = 0
