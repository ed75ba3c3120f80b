"""Wrappers of the RFF linear-attention kernels (``csrc/rff_attention.cu``).

* ``rff_attention_decode_block_cuda`` replaces
  ``repro/kernels/rff_attention.py::rff_attention_decode_block_pallas``:
  T decode tokens per head in one launch, the head's ``(D, dv)`` state
  held across the T ticks, q and k featurized in-kernel (prf or trig, f32
  or the bf16 contract of ``kernels/ref.py``).
* ``rff_attention_cuda`` replaces ``rff_attention_pallas``: chunked causal
  linear attention over featurized ``phi_q``, ``phi_k``, in two kernels
  (the state walked over chunks, then the outputs) through an f32
  workspace of each chunk's S_prev and z_prev
  (``chunking.linear_attention_plan``).

Each wrapper checks its inputs, allocates the outputs (and the workspace),
launches on the current stream, raises on a non-zero ``cudaError_t`` and
counts its calls in ``.launches``. CPU tensors are refused
(``kernels/ops.py`` routes them to the plain versions).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import decode_fits, linear_attention_plan
from repro_torch.kernels.ref import (
    canon_precision,
    default_decode_scale,
    prf_root,
)
from repro_torch.kernels.rff_klms_step import _check

__all__ = ["rff_attention_decode_block_cuda", "rff_attention_cuda"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # s_in, z_in, q, k, v, w, b, s, out, s_out, z_out, BH, T, dh, D, dv,
    # prf, bf16, normalize, eps, root_d, stream
    "rff_decode_block": (_P,) * 11 + (_I,) * 8 + (_F, _F, _P),
    # q, k, v, out, ws, ws_bytes, BH, S, D, dv, normalize, eps, stream
    "rff_linear_attention": (_P,) * 5 + (_L,) + (_I,) * 5 + (_F, _P),
    "rff_decode_block_smem_bytes": (_I, _I, _I),
    "rff_linear_attention_smem_bytes": (_I,),
    "rff_linear_attention_workspace_bytes": (_I,) * 4,
    "rff_attention_error_string": (_I,),
}


def _lib():
    lib = _build.load("rff_attention", _SIGNATURES)
    lib.rff_attention_error_string.restype = ctypes.c_char_p
    lib.rff_decode_block_smem_bytes.restype = ctypes.c_longlong
    lib.rff_linear_attention_smem_bytes.restype = ctypes.c_longlong
    lib.rff_linear_attention_workspace_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _root(dfeat: int) -> float:
    return prf_root(dfeat).item()


def _cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA {what} kernel takes CUDA tensors; use mode='ref' (or "
            f"'auto') for tensors on {t.device}"
        )
    return t.device


def _raise(lib, code: int, name: str) -> None:
    if code:
        msg = lib.rff_attention_error_string(code).decode()
        raise RuntimeError(f"{name} failed: cudaError {code} ({msg})")


def smem_bytes(lib=None) -> dict:
    """The kernels' own dynamic shared-memory sizes at D = 256, dv = dh =
    64 and 128, and the linear-attention workspace at the LM prefill (56
    heads, S = 2048, D = 256, dv = 64) and a ragged shape (for a check
    that ``kernels/chunking.py`` agrees)."""
    lib = lib or _lib()
    return {
        "decode_64": lib.rff_decode_block_smem_bytes(64, 256, 64),
        "decode_128": lib.rff_decode_block_smem_bytes(128, 256, 128),
        "linear_256": lib.rff_linear_attention_smem_bytes(256),
        "workspace_lm": lib.rff_linear_attention_workspace_bytes(
            56, 2048, 256, 64),
        "workspace_ragged": lib.rff_linear_attention_workspace_bytes(
            3, 100, 40, 200),
    }


def rff_attention_decode_block_cuda(s_state, z_state, q, k, v, w, b, s=None,
                                    *, feature_kind="prf", normalize=True,
                                    eps=1e-6, precision=None):
    """T decode ticks per head on the card: s_state (BH, D, dv), z_state
    (BH, D), q, k (BH, T, dh), v (BH, T, dv), w (dh, D), b (D,), s (D,)
    (None = ``default_decode_scale``), all f32. Returns (outputs (BH, T,
    dv), S', z'), f32."""
    device = _cuda(q, "decode-block")
    if feature_kind not in ("prf", "trig"):
        raise ValueError(f"unknown feature_kind {feature_kind!r}")
    bf16 = canon_precision(precision) == "bf16"
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, T, dh), got shape {tuple(q.shape)}")
    bh, tlen, dh = q.shape
    dfeat = w.shape[-1]
    dv = v.shape[-1]
    if s is None:
        s = default_decode_scale(dfeat, feature_kind, device)
    for name, t, shape in (
        ("s_state", s_state, (bh, dfeat, dv)),
        ("z_state", z_state, (bh, dfeat)),
        ("q", q, (bh, tlen, dh)), ("k", k, (bh, tlen, dh)),
        ("v", v, (bh, tlen, dv)), ("w", w, (dh, dfeat)), ("b", b, (dfeat,)),
        ("s", s, (dfeat,)),
    ):
        _check(name, t, shape, device)
    if dh < 1 or dfeat < 1 or dv < 1:
        raise ValueError(f"empty head: dh={dh}, D={dfeat}, dv={dv}")
    if not decode_fits(dfeat, dv, dh):
        raise ValueError(
            f"D={dfeat}, dv={dv}: one head's decode state exceeds the shared "
            "memory of a block"
        )
    out = torch.empty((bh, tlen, dv), device=device, dtype=torch.float32)
    s_new = torch.empty_like(s_state)
    z_new = torch.empty_like(z_state)
    if bh == 0:
        return out, s_new, z_new
    lib = _lib()
    code = lib.rff_decode_block(
        s_state.data_ptr(), z_state.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(),
        out.data_ptr(), s_new.data_ptr(), z_new.data_ptr(),
        bh, tlen, dh, dfeat, dv, int(feature_kind == "prf"), int(bf16),
        int(normalize), eps, _root(dfeat),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise(lib, code, "rff_decode_block")
    rff_attention_decode_block_cuda.launches += 1
    return out, s_new, z_new


rff_attention_decode_block_cuda.launches = 0


def rff_attention_cuda(phi_q, phi_k, v, *, chunk=256, normalize=True,
                       eps=1e-6):
    """Causal linear attention on the card: phi_q, phi_k (BH, S, D), v (BH,
    S, dv), f32 -> (BH, S, dv) f32. Raises unless S is a multiple of
    ``min(chunk, S)``, as ``repro`` asserts; the kernels' own chunk of 64
    rows is not part of the function. Allocates the f32 workspace of
    ``chunking.linear_attention_plan`` on the current stream."""
    device = _cuda(phi_q, "linear-attention")
    if phi_q.ndim != 3:
        raise ValueError(
            f"phi_q must be (BH, S, D), got shape {tuple(phi_q.shape)}")
    bh, slen, dfeat = phi_q.shape
    dv = v.shape[-1]
    c = min(chunk, slen)
    if c < 1 or slen % c:
        raise ValueError(f"sequence length {slen} is not a multiple of the "
                         f"chunk {c}")
    for name, t, shape in (("phi_q", phi_q, (bh, slen, dfeat)),
                           ("phi_k", phi_k, (bh, slen, dfeat)),
                           ("v", v, (bh, slen, dv))):
        _check(name, t, shape, device)
    if dfeat < 1 or dv < 1:
        raise ValueError(f"empty features: D={dfeat}, dv={dv}")
    out = torch.empty((bh, slen, dv), device=device, dtype=torch.float32)
    if bh == 0:
        return out
    nbytes = linear_attention_plan(bh, slen, dfeat, dv).workspace_bytes
    ws = torch.empty(nbytes // 4, device=device, dtype=torch.float32)
    lib = _lib()
    code = lib.rff_linear_attention(
        phi_q.data_ptr(), phi_k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr(), nbytes, bh, slen, dfeat, dv, int(normalize), eps,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise(lib, code, "rff_linear_attention")
    rff_attention_cuda.launches += 1
    return out


rff_attention_cuda.launches = 0
