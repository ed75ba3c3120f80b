"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_cuda`` replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``: exact softmax
attention on ``(BH, S, dh)`` (GQA kv repeated to full heads upstream), f32
or bf16 inputs, f32 statistics inside, the output in q's type. The wrapper
checks its inputs, allocates the output, launches on the current stream,
raises on a non-zero ``cudaError_t`` and counts its launches in
``.launches``. CPU tensors are refused (``kernels/ops.py`` routes them to
the plain version).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "MAX_HEAD_DIM"]

# The kernel's register accumulator covers 16 * 8 columns. This also bounds
# its shared memory: at dh = 128 the f32 tiles take 115 KB of a block's
# 227 KB.
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, out, BH, S, dh, bf16, causal, scale, stream
    "flash_attention": (_P,) * 4 + (_I,) * 5 + (ctypes.c_float, _P),
    "flash_attention_error_string": (_I,),
}


def _lib():
    lib = _build.load("flash_attention", _SIGNATURES)
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, *, causal=True):
    """Softmax attention on the card: q, k, v (BH, S, dh), all f32 or all
    bf16, contiguous, dh <= 128 -> (BH, S, dh) in q's type."""
    if q.device.type != "cuda":
        raise ValueError(
            "the CUDA flash-attention kernel takes CUDA tensors; use "
            f"mode='ref' (or 'auto') for tensors on {q.device}"
        )
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, S, dh), got shape {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    bh, slen, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (bh, slen, dh):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bh, slen, dh)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} outside [1, {MAX_HEAD_DIM}]")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the grid's 65535 heads")
    out = torch.empty_like(q)
    if bh == 0 or slen == 0:
        return out
    lib = _lib()
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, slen,
        dh, int(q.dtype == torch.bfloat16), int(causal), dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention failed: cudaError {code} ({msg})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
