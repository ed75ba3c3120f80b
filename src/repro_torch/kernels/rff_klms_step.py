"""Wrappers of the fused RFF-KLMS bank kernels (``csrc/klms_bank.cu``).

Two CUDA entry points share one ``__device__`` tick:

* ``klms_bank_chunk`` — T masked ticks per tenant in one launch, replacing
  ``repro/kernels/rff_klms_step.py::rff_klms_bank_chunk_pallas``;
* ``klms_bank_step`` — one unmasked tick, replacing
  ``rff_klms_bank_step_pallas``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (theta' is always a fresh tensor: a published
snapshot may still hold the input), launches on the current stream, raises
on a non-zero ``cudaError_t`` and counts its launches in ``.launches``.
A CPU tensor is refused: the plain versions live in ``kernels/ref.py`` and
``kernels/ops.py`` picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import klms_block_b
from repro_torch.kernels.ref import mu_column, default_scale

__all__ = ["rff_klms_bank_step_cuda", "rff_klms_bank_chunk_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # theta, xs, ys, mask, mu, w, b, s, theta_out, pred, err,
    # B, T, d, D, block_b, stream
    "klms_bank_chunk": (_P,) * 11 + (_I,) * 5 + (_P,),
    # theta, x, y, mu, w, b, s, theta_out, pred, err, B, d, D, block_b, stream
    "klms_bank_step": (_P,) * 10 + (_I,) * 4 + (_P,),
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


def _block_b(dfeat: int, d: int) -> int:
    bb = klms_block_b(dfeat, d)
    if not bb:
        raise ValueError(
            f"D={dfeat}, d={d}: one tenant's theta and z tiles exceed the "
            "shared memory of a block"
        )
    return bb


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
    lib = _lib()
    code = lib.klms_bank_chunk(
        theta.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        None if mask is None else mask.data_ptr(), mu.data_ptr(),
        w.data_ptr(), b.data_ptr(), s.data_ptr(),
        theta_out.data_ptr(), pred.data_ptr(), err.data_ptr(),
        bsz, tlen, d, dfeat, _block_b(dfeat, d),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, code, "klms_bank_chunk")
    rff_klms_bank_chunk_cuda.launches += 1
    return theta_out, pred, err


def rff_klms_bank_step_cuda(theta, x, y, w, b, mu, s=None):
    """One fused KLMS tick on the card: theta (B, D), x (B, d), y (B,).
    Returns (theta' (B, D), preds (B,), errs (B,))."""
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
    lib = _lib()
    code = lib.klms_bank_step(
        theta.data_ptr(), x.data_ptr(), y.data_ptr(), mu.data_ptr(),
        w.data_ptr(), b.data_ptr(), s.data_ptr(),
        theta_out.data_ptr(), pred.data_ptr(), err.data_ptr(),
        bsz, d, dfeat, _block_b(dfeat, d),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, code, "klms_bank_step")
    rff_klms_bank_step_cuda.launches += 1
    return theta_out, pred, err


rff_klms_bank_chunk_cuda.launches = 0
rff_klms_bank_step_cuda.launches = 0
