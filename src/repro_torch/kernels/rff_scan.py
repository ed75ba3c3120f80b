"""Wrappers of the replay element kernels (``csrc/rff_scan.cu``).

* ``klms_chunk_elements`` replaces
  ``repro/kernels/rff_scan.py::rff_klms_chunk_elements_pallas``: per
  chunk of Tc ticks, the composed KLMS (or NKLMS) affine element ``(A, v)``,
  in the closed (compact WY) form ``A = I - Z^T (T Z)``, ``v = Z^T (T y)``
  with ``T = (I + D_mu L)^-1 D_mu`` (a Gram, a triangular solve and two
  products; ``kernels/ref.py`` ``klms_chunk_elements_wy_ref`` is the same
  algebra in PyTorch);
* ``krls_chunk_elements`` replaces ``rff_krls_chunk_elements_pallas``: per
  chunk, the information-form element ``(g, Phi, r)``, in the closed form
  ``Phi = Z^T diag(w) Z``, ``r = Z^T (w y)``, ``g = beta^(live ticks)``
  with ``w_t = m_t beta^(live ticks after t)`` (one weighted Gram, its
  lower tiles mirrored; ``kernels/ref.py`` ``krls_chunk_elements_gram_ref``
  is the same algebra in PyTorch).

Each wrapper takes the time-blocked layout of ``repro`` (xs ``(nc, Tc,
d)``, ys and mask ``(nc, Tc)``), featurizes every tick with the feature
kernel (``kernels/rff_features.py``) into a ``(nc Tc, D)`` buffer and then
launches the element kernels over it, so together they compute what the
TPU kernel computes. Each call also allocates a workspace of at most
:data:`ELEMENT_WORKSPACE_BUDGET` bytes (or one chunk's, if that is more),
taken by the C entry a group of chunks at a time. Each checks device,
dtype, shape and contiguity, allocates its outputs with ``torch.empty``,
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts its calls in ``.launches``. CPU tensors are refused: the plain
versions live in ``kernels/ref.py`` and ``kernels/ops.py`` picks between
the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rff_features import launch as feature_launch
from repro_torch.kernels.chunking import feature_tile_pack_floats
from repro_torch.kernels.ref import default_scale
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_klms_chunk_elements_cuda", "rff_krls_chunk_elements_cuda",
           "ELEMENT_WORKSPACE_BUDGET"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_KLMS_ARGS = (_P,) * 6 + (_L,) + (_I,) * 3 + (_F, _I, _F, _P)
_SIGNATURES = {
    # z, ys, mask, a_out, v_out, ws, ws_floats, nc, tc, D, mu, normalized,
    # eps, stream
    "klms_chunk_elements": _KLMS_ARGS,
    "klms_element_chunk_floats": (_I, _I),
    # z, ys, mask, beta, g_out, phi_out, r_out, ws, ws_floats, nc, tc, D,
    # tile, stream
    "krls_chunk_elements": (_P,) * 3 + (_F,) + (_P,) * 4 + (_L,)
                           + (_I,) * 4 + (_P,),
    "krls_element_chunk_floats": (_I, _I),
    "rff_scan_error_string": (_I,),
}
# The workspace an element call allocates, unless one chunk needs more.
ELEMENT_WORKSPACE_BUDGET = 256 << 20
# The KRLS product's tiles a test may force (``_tile=``); None takes the
# plan's.
KRLS_TILES = (64, 32)


def _lib():
    lib = _build.load("rff_scan", _SIGNATURES)
    lib.rff_scan_error_string.restype = ctypes.c_char_p
    lib.klms_element_chunk_floats.restype = ctypes.c_longlong
    lib.krls_element_chunk_floats.restype = ctypes.c_longlong
    return lib


def _group(per: int, nc: int) -> int:
    """Chunks a workspace holds (``per`` floats each): as many as
    :data:`ELEMENT_WORKSPACE_BUDGET` holds, at least one, at most nc."""
    return max(1, min(nc, ELEMENT_WORKSPACE_BUDGET // (4 * per)))


def _check_blocks(xs, ys, w, b, mask, s):
    """Check the time-blocked inputs. Returns (device, s, the raw current
    stream)."""
    if xs.device.type != "cuda":
        raise ValueError(
            "the CUDA element kernels take CUDA tensors; use mode='ref' (or "
            f"'auto') for tensors on {xs.device}"
        )
    device = xs.device
    if xs.ndim != 3:
        raise ValueError(f"xs must be (nc, Tc, d), got shape {tuple(xs.shape)}")
    nc, tc, d = xs.shape
    dfeat = w.shape[-1]
    if s is None:
        s = default_scale(dfeat, device=device)
    rows = [("xs", xs, (nc, tc, d)), ("ys", ys, (nc, tc)), ("w", w, (d, dfeat)),
            ("b", b, (dfeat,)), ("s", s, (dfeat,))]
    if mask is not None:
        rows.append(("mask", mask, (nc, tc)))
    for name, t, shape in rows:
        _check(name, t, shape, device)
    if tc < 1:
        raise ValueError("chunks must hold at least one tick")
    return device, s, torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, code: int, kernel: str) -> None:
    if code:
        msg = lib.rff_scan_error_string(code).decode()
        raise RuntimeError(f"{kernel} failed: cudaError {code} ({msg})")


def rff_klms_chunk_elements_cuda(xs, ys, w, b, mu, mask=None, s=None,
                                 normalized=False, eps=1e-6):
    """Per-chunk composed KLMS elements on the card: xs (nc, Tc, d), ys
    (nc, Tc), shared w (d, D), b (D,), s (D,) (None = sqrt(2/D)), mu a
    scalar, mask optional (nc, Tc) gate (0 = the tick composes the
    identity). ``normalized`` sizes each tick's step as ``mu / (eps +
    ||z||^2)``. Returns ``(a (nc, D, D), v (nc, D))``. Tc <= 16384 and D
    <= 4194304.

    After the features, one C call runs the four phases (Gram, solve, T Z
    with v, the (D, Tc) (Tc, D) product) over as many chunks at a time as
    the workspace holds. The element is not bit for bit the fold of
    ``kernels/ref.py`` (another summation order), but two calls, and a
    chunk alone or among others, agree bit for bit, and a fully masked
    chunk is ``(I, 0)`` exactly."""
    device, s, stream = _check_blocks(xs, ys, w, b, mask, s)
    z = feature_launch(xs, w, b, s, False, stream)
    nc, tc, _ = xs.shape
    dfeat = w.shape[-1]
    lib = _lib()
    per = lib.klms_element_chunk_floats(tc, dfeat)
    if per < 1:
        raise ValueError(f"Tc={tc}, D={dfeat}: the KLMS element kernel takes "
                         "Tc <= 16384 and D <= 4194304")
    a = torch.empty((nc, dfeat, dfeat), dtype=torch.float32, device=device)
    v = torch.empty((nc, dfeat), dtype=torch.float32, device=device)
    if nc == 0:
        return a, v
    ws = torch.empty(_group(per, nc) * per, dtype=torch.float32,
                     device=device)
    code = lib.klms_chunk_elements(
        z.data_ptr(), ys.data_ptr(), None if mask is None else mask.data_ptr(),
        a.data_ptr(), v.data_ptr(), ws.data_ptr(), ws.numel(), nc, tc, dfeat,
        float(mu), int(bool(normalized)), float(eps), stream,
    )
    _raise_on(lib, code, "klms_chunk_elements")
    rff_klms_chunk_elements_cuda.launches += 1
    return a, v


def rff_krls_chunk_elements_cuda(xs, ys, w, b, beta, mask=None, s=None, *,
                                 _tile=None):
    """Per-chunk composed KRLS decay elements on the card: layout as
    :func:`rff_klms_chunk_elements_cuda`, ``beta`` the scalar forgetting
    factor. Returns ``(g (nc,), phi (nc, D, D), r (nc, D))``. Tc <= 16384
    and D <= 4194304.

    After the features, one C call runs two launches over as many chunks
    at a time as the workspace holds: the weights w (a suffix chain of f32
    multiplies; g is the fold's g bit for bit) with Z and w Z packed, then
    the lower tiles of ``Z^T (w Z)`` stored mirrored, and r. The element is
    not bit for bit the fold of ``kernels/ref.py`` (another rounding
    sequence), but Phi equals Phi^T, two calls, a chunk alone or among
    others, and either tile (64 or 32; the plan picks one from the
    count of lower tiles, a test may force one with the private
    ``_tile=``) agree bit for bit, and a fully masked chunk is ``(1, 0,
    0)`` exactly."""
    device, s, stream = _check_blocks(xs, ys, w, b, mask, s)
    nc, tc, d = xs.shape
    dfeat = w.shape[-1]
    if _tile is not None and _tile not in KRLS_TILES:
        raise ValueError(f"_tile={_tile}: the product takes {KRLS_TILES}")
    lib = _lib()
    per = lib.krls_element_chunk_floats(tc, dfeat)
    if per < 1:
        raise ValueError(f"Tc={tc}, D={dfeat}: the KRLS element kernel takes "
                         "Tc <= 16384 and D <= 4194304")
    g = torch.empty((nc,), dtype=torch.float32, device=device)
    phi = torch.empty((nc, dfeat, dfeat), dtype=torch.float32, device=device)
    r = torch.empty((nc, dfeat), dtype=torch.float32, device=device)
    if nc == 0:
        return g, phi, r
    # One workspace: the elements' chunks, then the features' packed
    # operands (per is a multiple of 128 floats, so both start on 16 bytes).
    group = _group(per, nc)
    ws = torch.empty(group * per + feature_tile_pack_floats(nc * tc, d, dfeat),
                     dtype=torch.float32, device=device)
    z = feature_launch(xs, w, b, s, False, stream,
                            ws_ptr=ws.data_ptr() + 4 * group * per)
    code = lib.krls_chunk_elements(
        z.data_ptr(), ys.data_ptr(), None if mask is None else mask.data_ptr(),
        float(beta), g.data_ptr(), phi.data_ptr(), r.data_ptr(),
        ws.data_ptr(), group * per, nc, tc, dfeat, _tile or 0, stream,
    )
    _raise_on(lib, code, "krls_chunk_elements")
    rff_krls_chunk_elements_cuda.launches += 1
    return g, phi, r


rff_klms_chunk_elements_cuda.launches = 0
rff_krls_chunk_elements_cuda.launches = 0
