"""Wrappers of the fused RFF-KRLS bank kernels (``csrc/krls_bank.cu``,
``csrc/krls_compact.cu``).

Three routes, each a C entry point that takes T masked EW-RLS ticks per
tenant in one call, replacing
``repro/kernels/rff_krls_step.py::rff_krls_bank_chunk_pallas``:

* ``"resident"`` (``krls_bank_chunk_resident``) keeps P's packed upper
  triangle in shared memory for the whole launch; it takes D up to 335 at
  d = 5 (``chunking.krls_resident_fits``), and is picked there for a step
  and for the calls too short or too narrow for the compact route to pay
  (``chunking.krls_compact_pays``);
* ``"compact"`` (``krls_bank_chunk_compact``) takes every wider D, and at
  D <= 335 the calls where its blocks cost less than the resident route's
  ticks (the serving flush of 16 ticks at B = 1024, D = 300 among them):
  per block of ``chunking.KRLS_COMPACT_TC`` ticks it reads P once for P_0 Z^T,
  runs the recursion on (Tc, Tc) products in float64 and applies the
  block's rank-L update to P in one more pass (12 B D^2 bytes a block). It
  equals the tick recursion in exact arithmetic, not bit for bit: a chunk
  of T equals T steps within the f32 tolerances, not to the bit. Tc = 16:
  no Tc up to 128 failed a KRLS bound (``krls_breakdown.py --compact``'s Tc
  study puts the f32 error at 0.07-0.45 of the tick form's, against the
  budget's 2), so the serving flush's 16 ticks set it (the rule beside
  ``chunking.krls_resident_fits``). ``kernels/ref.py``
  ``krls_chunk_compact_ref`` is its plain version;
* ``"streaming"`` (``krls_bank_chunk``) moves P through device memory twice
  a tick, for any D. No caller picks it; the tests and timings force it
  with ``_route="streaming"``, to hold the other routes against it.

``rff_krls_bank_chunk_cuda`` picks the route with :func:`krls_chunk_route`.
``rff_krls_bank_step_cuda``, which replaces ``rff_krls_bank_step_pallas``,
takes the same route at T = 1 (:func:`krls_step_route`), or the streaming
design's step kernel (``krls_bank_step``) when forced; a step equals a
chunk at T = 1 bit for bit on every route. Both count their launches in
``.launches`` and per route in ``.route_launches``, and take ``_route=``
("resident", "compact" or "streaming") to force one.

Each wrapper checks device, dtype, shape and contiguity, allocates fresh
``theta_out`` and ``p_out`` (and the compact route's workspace, at most
``chunking.KRLS_COMPACT_WORKSPACE_BUDGET`` bytes, tenants in slabs past it)
with ``torch.empty`` (a published snapshot may still hold the inputs),
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts the launch. A CPU tensor is refused: the plain versions live in
``kernels/ref.py`` and ``kernels/ops.py`` picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import (
    KRLS_COMPACT_TC,
    krls_compact_pays,
    krls_compact_slab,
    krls_compact_workspace_bytes,
    krls_fits,
    krls_resident_fits,
)
from repro_torch.kernels.ref import beta_column, default_scale
from repro_torch.kernels.rff_klms_step import _check, _cuda_device

__all__ = ["rff_krls_bank_step_cuda", "rff_krls_bank_chunk_cuda",
           "krls_chunk_route", "krls_step_route", "KRLS_ROUTES"]

KRLS_ROUTES = ("resident", "compact", "streaming")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_CHUNK = (_P,) * 13 + (_I,) * 4 + (_P,)
_SIGNATURES = {
    # theta, pmat, xs, ys, mask, beta, w, b, s, theta_out, p_out, pred, err,
    # B, T, d, D, stream
    "krls_bank_chunk": _CHUNK,
    "krls_bank_chunk_resident": _CHUNK,
    # theta, pmat, x, y, beta, w, b, s, theta_out, p_out, pred, err,
    # B, d, D, stream
    "krls_bank_step": (_P,) * 12 + (_I,) * 3 + (_P,),
    "krls_bank_error_string": (_I,),
}
_COMPACT_SIGNATURES = {
    # krls_bank_chunk's, then ws, ws_bytes, slab
    "krls_bank_chunk_compact": _CHUNK + (_P, _L, _I),
    "krls_compact_workspace_bytes": (_I,) * 4,
    "krls_compact_tc": (),
    "krls_compact_error_string": (_I,),
}


def _lib():
    lib = _build.load("krls_bank", _SIGNATURES)
    lib.krls_bank_error_string.restype = ctypes.c_char_p
    return lib


def _compact_lib():
    lib = _build.load("krls_compact", _COMPACT_SIGNATURES)
    lib.krls_compact_error_string.restype = ctypes.c_char_p
    lib.krls_compact_workspace_bytes.restype = ctypes.c_longlong
    if lib.krls_compact_tc() != KRLS_COMPACT_TC:
        raise RuntimeError(
            f"csrc/krls_compact.cu takes blocks of {lib.krls_compact_tc()} "
            f"ticks, chunking.KRLS_COMPACT_TC is {KRLS_COMPACT_TC}")
    return lib


def krls_chunk_route(bank: int, tlen: int, dfeat: int, input_dim: int) -> str:
    """The chunk kernel a call of B = ``bank`` tenants and T = ``tlen``
    ticks at width D = ``dfeat`` goes to: "compact" when P's triangle does
    not fit a block's shared memory or when the compact route is the faster
    for the shape (``chunking.krls_compact_pays``: the serving flush, not a
    step), else "resident"."""
    if (not krls_resident_fits(dfeat, input_dim)
            or krls_compact_pays(bank, tlen, dfeat)):
        return "compact"
    return "resident"


def krls_step_route(bank: int, dfeat: int, input_dim: int) -> str:
    """The kernel one step of B = ``bank`` tenants at width D = ``dfeat``
    goes to: the chunk's route at T = 1."""
    return krls_chunk_route(bank, 1, dfeat, input_dim)


def _route_of(route, bank: int, tlen: int, dfeat: int, input_dim: int) -> str:
    route = route or krls_chunk_route(bank, tlen, dfeat, input_dim)
    if route not in KRLS_ROUTES:
        raise ValueError(f"unknown KRLS route {route!r}; use one of "
                         f"{KRLS_ROUTES}")
    return route


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


def _raise_on(code: int, kernel: str, error_string) -> None:
    if code:
        msg = error_string(code).decode()
        raise RuntimeError(f"{kernel} failed: cudaError {code} ({msg})")


def _chunk(route, ins, mask, outs, bsz, tlen, d, dfeat, stream):
    """Launch one chunk route: ``ins`` (theta, pmat, xs, ys, then the
    shared beta, w, b, s), ``outs`` (theta', P', pred, err), mask None or
    (B, T)."""
    theta, pmat, xs, ys, beta, w, b, s = ins
    args = (theta.data_ptr(), pmat.data_ptr(), xs.data_ptr(), ys.data_ptr(),
            None if mask is None else mask.data_ptr(), beta.data_ptr(),
            w.data_ptr(), b.data_ptr(), s.data_ptr(),
            *(t.data_ptr() for t in outs), bsz, tlen, d, dfeat, stream)
    if route == "compact":
        lib = _compact_lib()
        slab = krls_compact_slab(bsz, tlen, d, dfeat)
        nbytes = krls_compact_workspace_bytes(
            slab, min(KRLS_COMPACT_TC, tlen), d, dfeat)
        ws = torch.empty(nbytes, dtype=torch.uint8, device=theta.device)
        code = lib.krls_bank_chunk_compact(*args, ws.data_ptr(), nbytes, slab)
        _raise_on(code, "krls_bank_chunk_compact",
                  lib.krls_compact_error_string)
        return
    lib = _lib()
    entry = {"resident": "krls_bank_chunk_resident",
             "streaming": "krls_bank_chunk"}[route]
    _raise_on(getattr(lib, entry)(*args), entry, lib.krls_bank_error_string)


def rff_krls_bank_chunk_cuda(theta, pmat, xs, ys, w, b, beta, mask=None,
                             s=None, *, _route=None):
    """T-chunked fused EW-RLS on the card: theta (B, D), pmat (B, D, D), xs
    (B, T, d), ys (B, T), shared w (d, D), b (D,), s (D,) (None =
    sqrt(2/D)), beta scalar or (B,), mask optional (B, T) gate. Returns
    (theta' (B, D), P' (B, D, D), preds (B, T), errs (B, T)), from the
    kernel :func:`krls_chunk_route` picks (``_route`` forces one, for the
    tests and timings that hold the routes against each other)."""
    bsz, tlen, d = xs.shape
    rows = [("xs", xs, (bsz, tlen, d)), ("ys", ys, (bsz, tlen))]
    if mask is not None:
        rows.append(("mask", mask, (bsz, tlen)))
    route = _route_of(_route, bsz, tlen, theta.shape[-1], d)
    device, beta, s = _prepare(theta, pmat, rows, w, b, beta, s)
    outs = _outputs(theta, pmat, (tlen,))
    if bsz == 0 or tlen == 0:
        outs[0].copy_(theta)
        outs[1].copy_(pmat)
        return outs
    _chunk(route, (theta, pmat, xs, ys, beta, w, b, s), mask, outs, bsz,
           tlen, d, theta.shape[1],
           torch.cuda.current_stream(device).cuda_stream)
    rff_krls_bank_chunk_cuda.launches += 1
    rff_krls_bank_chunk_cuda.route_launches[route] += 1
    return outs


def rff_krls_bank_step_cuda(theta, pmat, x, y, w, b, beta, s=None, *,
                            _route=None):
    """One fused EW-RLS tick on the card: theta (B, D), pmat (B, D, D), x
    (B, d), y (B,). Returns (theta' (B, D), P' (B, D, D), preds (B,), errs
    (B,)), from the kernel :func:`krls_step_route` picks: the chunk's route
    at T = 1, or with ``_route="streaming"`` the streaming step kernel."""
    bsz, d = x.shape
    rows = [("x", x, (bsz, d)), ("y", y, (bsz,))]
    route = _route_of(_route, bsz, 1, theta.shape[-1], d)
    device, beta, s = _prepare(theta, pmat, rows, w, b, beta, s)
    outs = _outputs(theta, pmat, ())
    if bsz == 0:
        return outs
    stream = torch.cuda.current_stream(device).cuda_stream
    if route == "streaming":
        lib = _lib()
        code = lib.krls_bank_step(
            theta.data_ptr(), pmat.data_ptr(), x.data_ptr(), y.data_ptr(),
            beta.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
            *(t.data_ptr() for t in outs), bsz, d, theta.shape[1], stream)
        _raise_on(code, "krls_bank_step", lib.krls_bank_error_string)
    else:  # the chunk at T = 1: x as (B, 1, d), y, pred and err as (B, 1)
        _chunk(route, (theta, pmat, x, y, beta, w, b, s), None, outs, bsz, 1,
               d, theta.shape[1], stream)
    rff_krls_bank_step_cuda.launches += 1
    rff_krls_bank_step_cuda.route_launches[route] += 1
    return outs


rff_krls_bank_chunk_cuda.launches = 0
rff_krls_bank_chunk_cuda.route_launches = dict.fromkeys(KRLS_ROUTES, 0)
rff_krls_bank_step_cuda.launches = 0
rff_krls_bank_step_cuda.route_launches = dict.fromkeys(KRLS_ROUTES, 0)
