"""Wrappers of the fused RFF-KRLS bank kernels (``csrc/krls_bank.cu``).

Three CUDA entry points, with one tick's arithmetic:

* ``krls_bank_chunk_resident`` and ``krls_bank_chunk`` — T masked EW-RLS
  ticks per tenant in one launch, replacing
  ``repro/kernels/rff_krls_step.py::rff_krls_bank_chunk_pallas``. The
  first keeps P's packed upper triangle in shared memory for the whole
  launch; it takes D up to 335 at d = 5
  (``chunking.krls_resident_fits``). The second streams P through device
  memory every tick and takes the wider D. ``rff_krls_bank_chunk_cuda``
  picks the route (``krls_chunk_route``) and counts it in
  ``.route_launches``;
* ``krls_bank_step`` — one unmasked tick with P streamed, the step
  kernel for the wider D. ``rff_krls_bank_step_cuda``, which replaces
  ``rff_krls_bank_step_pallas``, launches the resident chunk kernel at T =
  1 instead wherever P's triangle fits (``krls_step_route``; its first
  tick moves P in and out once), and counts the route in
  ``.route_launches``. A chunk of T equals T steps bit for bit on either
  route, and the two step routes agree bit for bit.

Each wrapper checks device, dtype, shape and contiguity, allocates fresh
``theta_out`` and ``p_out`` with ``torch.empty`` (a published snapshot may
still hold the inputs), launches on the current stream, raises on a
non-zero ``cudaError_t`` and counts its launches in ``.launches``. A CPU
tensor is refused: the plain versions live in ``kernels/ref.py`` and
``kernels/ops.py`` picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import krls_fits, krls_resident_fits
from repro_torch.kernels.ref import beta_column, default_scale
from repro_torch.kernels.rff_klms_step import _check, _cuda_device

__all__ = ["rff_krls_bank_step_cuda", "rff_krls_bank_chunk_cuda",
           "krls_chunk_route", "krls_step_route"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # theta, pmat, xs, ys, mask, beta, w, b, s, theta_out, p_out, pred, err,
    # B, T, d, D, stream
    "krls_bank_chunk": (_P,) * 13 + (_I,) * 4 + (_P,),
    "krls_bank_chunk_resident": (_P,) * 13 + (_I,) * 4 + (_P,),
    # theta, pmat, x, y, beta, w, b, s, theta_out, p_out, pred, err,
    # B, d, D, stream
    "krls_bank_step": (_P,) * 12 + (_I,) * 3 + (_P,),
    "krls_bank_error_string": (_I,),
}


def _lib():
    lib = _build.load("krls_bank", _SIGNATURES)
    lib.krls_bank_error_string.restype = ctypes.c_char_p
    return lib


def krls_chunk_route(dfeat: int, input_dim: int) -> str:
    """The chunk kernel a bank of width D = ``dfeat`` goes to: "resident"
    when P's triangle fits a block's shared memory, else "streaming"."""
    return "resident" if krls_resident_fits(dfeat, input_dim) else "streaming"


def krls_step_route(dfeat: int, input_dim: int) -> str:
    """The kernel one step of width D = ``dfeat`` goes to: "resident" (the
    resident chunk kernel at T = 1) when P's triangle fits a block's shared
    memory, else "streaming" (the step kernel)."""
    return krls_chunk_route(dfeat, input_dim)


def _prepare(theta, pmat, rows, w, b, beta, s):
    """Checked common arguments: (device, beta (B,), s (D,))."""
    device = _cuda_device(theta)
    bsz, dfeat = theta.shape
    d = w.shape[0]
    if not krls_fits(dfeat, d):
        raise ValueError(
            f"D={dfeat}, d={d}: the KRLS kernel's shared tiles exceed the "
            "shared memory of a block"
        )
    beta = beta_column(beta, theta, bsz).contiguous()
    if s is None:
        s = default_scale(dfeat, device=device)
    for name, t, shape in (
        ("theta", theta, (bsz, dfeat)), ("pmat", pmat, (bsz, dfeat, dfeat)),
        ("w", w, (d, dfeat)), ("b", b, (dfeat,)), ("s", s, (dfeat,)),
        ("beta", beta, (bsz,)), *rows,
    ):
        _check(name, t, shape, device)
    return device, beta, s


def _outputs(theta, pmat, tail):
    pred = torch.empty((theta.shape[0], *tail), dtype=torch.float32,
                       device=theta.device)
    return torch.empty_like(theta), torch.empty_like(pmat), pred, torch.empty_like(pred)


def _raise_on(lib, code: int, kernel: str) -> None:
    if code:
        msg = lib.krls_bank_error_string(code).decode()
        raise RuntimeError(f"{kernel} failed: cudaError {code} ({msg})")


def rff_krls_bank_chunk_cuda(theta, pmat, xs, ys, w, b, beta, mask=None,
                             s=None):
    """T-chunked fused EW-RLS on the card: theta (B, D), pmat (B, D, D), xs
    (B, T, d), ys (B, T), shared w (d, D), b (D,), s (D,) (None =
    sqrt(2/D)), beta scalar or (B,), mask optional (B, T) gate. Returns
    (theta' (B, D), P' (B, D, D), preds (B, T), errs (B, T)), from the
    kernel :func:`krls_chunk_route` picks."""
    bsz, tlen, d = xs.shape
    rows = [("xs", xs, (bsz, tlen, d)), ("ys", ys, (bsz, tlen))]
    if mask is not None:
        rows.append(("mask", mask, (bsz, tlen)))
    device, beta, s = _prepare(theta, pmat, rows, w, b, beta, s)
    theta_out, p_out, pred, err = _outputs(theta, pmat, (tlen,))
    if bsz == 0 or tlen == 0:
        theta_out.copy_(theta)
        p_out.copy_(pmat)
        return theta_out, p_out, pred, err
    route = krls_chunk_route(theta.shape[1], d)
    lib = _lib()
    entry = {"resident": "krls_bank_chunk_resident",
             "streaming": "krls_bank_chunk"}[route]
    code = getattr(lib, entry)(
        theta.data_ptr(), pmat.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        None if mask is None else mask.data_ptr(), beta.data_ptr(),
        w.data_ptr(), b.data_ptr(), s.data_ptr(),
        theta_out.data_ptr(), p_out.data_ptr(), pred.data_ptr(),
        err.data_ptr(), bsz, tlen, d, theta.shape[1],
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(lib, code, entry)
    rff_krls_bank_chunk_cuda.launches += 1
    rff_krls_bank_chunk_cuda.route_launches[route] += 1
    return theta_out, p_out, pred, err


def rff_krls_bank_step_cuda(theta, pmat, x, y, w, b, beta, s=None, *,
                            _route=None):
    """One fused EW-RLS tick on the card: theta (B, D), pmat (B, D, D), x
    (B, d), y (B,). Returns (theta' (B, D), P' (B, D, D), preds (B,), errs
    (B,)), from the kernel :func:`krls_step_route` picks (``_route``
    forces one, for the tests that hold the routes against each other)."""
    bsz, d = x.shape
    rows = [("x", x, (bsz, d)), ("y", y, (bsz,))]
    device, beta, s = _prepare(theta, pmat, rows, w, b, beta, s)
    theta_out, p_out, pred, err = _outputs(theta, pmat, ())
    if bsz == 0:
        return theta_out, p_out, pred, err
    route = _route or krls_step_route(theta.shape[1], d)
    lib = _lib()
    ptrs = (theta.data_ptr(), pmat.data_ptr(), x.data_ptr(), y.data_ptr())
    outs = (theta_out.data_ptr(), p_out.data_ptr(), pred.data_ptr(),
            err.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    if route == "resident":  # x as (B, 1, d), y, pred and err as (B, 1)
        entry = "krls_bank_chunk_resident"
        code = lib.krls_bank_chunk_resident(
            *ptrs, None, beta.data_ptr(), w.data_ptr(), b.data_ptr(),
            s.data_ptr(), *outs, bsz, 1, d, theta.shape[1], stream)
    elif route == "streaming":
        entry = "krls_bank_step"
        code = lib.krls_bank_step(
            *ptrs, beta.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
            *outs, bsz, d, theta.shape[1], stream)
    else:
        raise ValueError(f"unknown KRLS step route {route!r}")
    _raise_on(lib, code, entry)
    rff_krls_bank_step_cuda.launches += 1
    rff_krls_bank_step_cuda.route_launches[route] += 1
    return theta_out, p_out, pred, err


rff_krls_bank_chunk_cuda.launches = 0
rff_krls_bank_chunk_cuda.route_launches = {"resident": 0, "streaming": 0}
rff_krls_bank_step_cuda.launches = 0
rff_krls_bank_step_cuda.route_launches = {"resident": 0, "streaming": 0}
