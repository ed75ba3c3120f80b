"""Wrappers of the fused RFF-KLMS bank kernels (``csrc/klms_bank.cu``).

Two CUDA entry points share one code path:

* ``klms_bank_chunk`` — T masked ticks per tenant in one call, replacing
  ``repro/kernels/rff_klms_step.py::rff_klms_bank_chunk_pallas``;
* ``klms_bank_step`` — one unmasked tick (the chunk at T = 1), replacing
  ``rff_klms_bank_step_pallas``.

A call packs W (with b and s) and x for the feature tile, forms the
features of all B T rows as one tiled GEMM with a cosine epilogue into a
``(B, T, D)`` f32 workspace (at most :data:`KLMS_WORKSPACE_BUDGET` bytes;
past it the ticks go in slabs, x packed for each), then runs the tick loop,
one warp per tenant. ``.launches`` counts one per call.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and the workspace with ``torch.empty`` (theta' is always a fresh
tensor: a published snapshot may still hold the input), launches on the
current stream, raises on a non-zero ``cudaError_t`` and counts its calls
in ``.launches``. A CPU tensor is refused: the plain versions live in
``kernels/ref.py`` and ``kernels/ops.py`` picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import (
    feature_tile_grid,
    feature_tile_pack_floats,
    klms_tick_plan,
)
from repro_torch.kernels.ref import mu_column, default_scale

__all__ = ["rff_klms_bank_step_cuda", "rff_klms_bank_chunk_cuda",
           "KLMS_WORKSPACE_BUDGET", "klms_slab_ticks"]

# The largest feature workspace one call allocates: 256 MiB, two T = 16
# flushes of the serving bank (B = 1024, D = 2048: 8 MiB a tick).
KLMS_WORKSPACE_BUDGET = 256 << 20

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # theta, xs, ys, mask, mu, w, b, s, z, pk, pk_floats, theta_out, pred,
    # err, B, T, d, D, reg_cols, slab, stream
    "klms_bank_chunk": (_P,) * 10 + (_L,) + (_P,) * 3 + (_I,) * 6 + (_P,),
    # theta, x, y, mu, w, b, s, z, pk, pk_floats, theta_out, pred, err, B,
    # d, D, reg_cols, stream
    "klms_bank_step": (_P,) * 9 + (_L,) + (_P,) * 3 + (_I,) * 4 + (_P,),
    "klms_bank_error_string": (_I,),
}


def _lib():
    lib = _build.load("klms_bank", _SIGNATURES)
    lib.klms_bank_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(theta: torch.Tensor) -> torch.device:
    if theta.device.type != "cuda":
        raise ValueError(
            "the CUDA bank kernels take CUDA tensors; use mode='ref' (or "
            f"'auto') for tensors on {theta.device}"
        )
    return theta.device


def klms_slab_ticks(bank: int, tlen: int, dfeat: int) -> int:
    """Ticks one slab of a call takes: all T while the ``(B, T, D)`` f32
    workspace fits :data:`KLMS_WORKSPACE_BUDGET`, else the most that do
    (at least one). The bits do not depend on it."""
    per_tick = 4 * bank * dfeat
    return max(1, min(tlen, KLMS_WORKSPACE_BUDGET // max(per_tick, 1)))


def _workspaces(rows: int, d: int, dfeat: int, device):
    """One f32 allocation split into the ``rows`` feature rows z and the
    feature tile's packed x and W for them (from a 256-byte boundary: the
    kernel copies 16-byte chunks)."""
    zn = rows * dfeat
    start = -(-zn // 64) * 64
    ws = torch.empty(start + feature_tile_pack_floats(rows, d, dfeat),
                     dtype=torch.float32, device=device)
    return ws[:zn], ws[start:]


def _plan(bsz: int, tlen: int, dfeat: int) -> int:
    """Columns a lane keeps in registers (0: shared memory); raises on a
    shape the kernels do not take."""
    feature_tile_grid(bsz * tlen, dfeat)
    return klms_tick_plan(dfeat)[0]


def _raise_on(lib, code: int, kernel: str) -> None:
    if code:
        msg = lib.klms_bank_error_string(code).decode()
        raise RuntimeError(f"{kernel} failed: cudaError {code} ({msg})")


def rff_klms_bank_chunk_cuda(theta, xs, ys, w, b, mu, mask=None, s=None):
    """T-chunked fused KLMS on the card: theta (B, D), xs (B, T, d), ys
    (B, T), shared w (d, D), b (D,), s (D,) (None = sqrt(2/D)), mu scalar
    or (B,), mask optional (B, T) gate. Returns (theta' (B, D), preds
    (B, T), errs (B, T))."""
    device = _cuda_device(theta)
    bsz, tlen, d = xs.shape
    dfeat = theta.shape[-1]
    mu = mu_column(mu, theta, bsz).contiguous()
    if s is None:
        s = default_scale(dfeat, device=device)
    for name, t, shape in (
        ("theta", theta, (bsz, dfeat)), ("xs", xs, (bsz, tlen, d)),
        ("ys", ys, (bsz, tlen)), ("w", w, (d, dfeat)), ("b", b, (dfeat,)),
        ("s", s, (dfeat,)), ("mu", mu, (bsz,)),
    ):
        _check(name, t, shape, device)
    if mask is not None:
        _check("mask", mask, (bsz, tlen), device)
    theta_out = torch.empty_like(theta)
    pred = torch.empty((bsz, tlen), dtype=torch.float32, device=device)
    err = torch.empty_like(pred)
    if bsz == 0 or tlen == 0:
        theta_out.copy_(theta)
        return theta_out, pred, err
    reg_cols = _plan(bsz, tlen, dfeat)
    slab = klms_slab_ticks(bsz, tlen, dfeat)
    z, pk = _workspaces(bsz * slab, d, dfeat, device)
    lib = _lib()
    code = lib.klms_bank_chunk(
        theta.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        None if mask is None else mask.data_ptr(), mu.data_ptr(),
        w.data_ptr(), b.data_ptr(), s.data_ptr(), z.data_ptr(),
        pk.data_ptr(), pk.numel(),
        theta_out.data_ptr(), pred.data_ptr(), err.data_ptr(),
        bsz, tlen, d, dfeat, reg_cols, slab,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, code, "klms_bank_chunk")
    rff_klms_bank_chunk_cuda.launches += 1
    return theta_out, pred, err


def rff_klms_bank_step_cuda(theta, x, y, w, b, mu, s=None):
    """One fused KLMS tick on the card (the chunk at T = 1, no mask):
    theta (B, D), x (B, d), y (B,). Returns (theta' (B, D), preds (B,),
    errs (B,))."""
    device = _cuda_device(theta)
    bsz, d = x.shape
    dfeat = theta.shape[-1]
    mu = mu_column(mu, theta, bsz).contiguous()
    if s is None:
        s = default_scale(dfeat, device=device)
    for name, t, shape in (
        ("theta", theta, (bsz, dfeat)), ("x", x, (bsz, d)),
        ("y", y, (bsz,)), ("w", w, (d, dfeat)), ("b", b, (dfeat,)),
        ("s", s, (dfeat,)), ("mu", mu, (bsz,)),
    ):
        _check(name, t, shape, device)
    theta_out = torch.empty_like(theta)
    pred = torch.empty((bsz,), dtype=torch.float32, device=device)
    err = torch.empty_like(pred)
    if bsz == 0:
        return theta_out, pred, err
    reg_cols = _plan(bsz, 1, dfeat)
    z, pk = _workspaces(bsz, d, dfeat, device)
    lib = _lib()
    code = lib.klms_bank_step(
        theta.data_ptr(), x.data_ptr(), y.data_ptr(), mu.data_ptr(),
        w.data_ptr(), b.data_ptr(), s.data_ptr(), z.data_ptr(),
        pk.data_ptr(), pk.numel(),
        theta_out.data_ptr(), pred.data_ptr(), err.data_ptr(),
        bsz, d, dfeat, reg_cols,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, code, "klms_bank_step")
    rff_klms_bank_step_cuda.launches += 1
    return theta_out, pred, err


rff_klms_bank_chunk_cuda.launches = 0
rff_klms_bank_step_cuda.launches = 0
