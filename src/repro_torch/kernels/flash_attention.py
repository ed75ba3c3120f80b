"""Wrapper of the flash-attention kernels, one route a dtype.

``flash_attention_cuda`` replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``: exact softmax
attention on ``(BH, S, dh)`` (GQA kv repeated to full heads upstream), f32
statistics inside, the output in q's type. It routes by dtype:

* bf16 -> ``csrc/flash_attention_sm90.cu``, the tensor-core kernel (wgmma
  products, TMA loads into a two-stage ring, P rounded to bf16 for P V);
* f32 -> ``csrc/flash_attention.cu``, the CUDA-core kernel in IEEE f32
  (f32 never runs on TF32 in this port).

The wrapper checks its inputs, allocates the output, launches on the
current stream, raises on a non-zero return code and counts its launches
in ``.launches`` and, per route, in ``.route_launches``. CPU tensors are
refused (``kernels/ops.py`` routes them to the plain version).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "flash_plan", "MAX_HEAD_DIM", "ROUTES"]

# Both kernels cover dh <= 128: the CUDA-core kernel's register accumulator
# is 16 * 8 columns (its f32 tiles take 115 KB of shared memory at 128);
# the tensor-core kernel pads dh to one or two 64-column swizzle atoms.
MAX_HEAD_DIM = 128
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}

_P = ctypes.c_void_p
_I = ctypes.c_int
# q, k, v, out, BH, S, dh, causal, scale, stream
_ARGS = (_P,) * 4 + (_I,) * 4 + (ctypes.c_float, _P)
_LIBS = {
    "cuda_core": ("flash_attention", "flash_attention"),
    "tensor_core": ("flash_attention_sm90", "flash_attention_bf16"),
}


def _lib(route: str):
    source, entry = _LIBS[route]
    lib = _build.load(source, {entry: _ARGS, f"{entry}_error_string": (_I,)})
    getattr(lib, f"{entry}_error_string").restype = ctypes.c_char_p
    return lib


def flash_plan(q, k, v) -> tuple[str, str, str, int]:
    """Check q, k, v (the device aside) and say how the card runs them:
    (route, source, C entry, head width the kernel sees). bf16 goes to the
    tensor-core kernel with dh padded to a multiple of 8 (TMA reads rows of
    a multiple of 16 bytes; zero columns change neither the scores nor the
    kept outputs); f32 to the CUDA-core kernel as it is."""
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, S, dh), got shape {tuple(q.shape)}")
    if q.dtype not in ROUTES:
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
    route = ROUTES[q.dtype]
    width = dh + (-dh % 8 if route == "tensor_core" else 0)
    return (route, *_LIBS[route], width)


def _aligned(t):
    """t itself, or a fresh copy when its address is not 16-byte aligned
    (TMA reads from 16-byte aligned rows)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q, k, v, *, causal=True):
    """Softmax attention on the card: q, k, v (BH, S, dh), all f32 or all
    bf16, contiguous, dh <= 128 -> (BH, S, dh) in q's type."""
    if q.device.type != "cuda":
        raise ValueError(
            "the CUDA flash-attention kernel takes CUDA tensors; use "
            f"mode='ref' (or 'auto') for tensors on {q.device}"
        )
    route, _, entry, width = flash_plan(q, k, v)
    bh, slen, dh = q.shape
    if bh == 0 or slen == 0:
        return torch.empty_like(q)
    if width != dh:
        q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
    if route == "tensor_core":
        q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _lib(route)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, slen,
        width, int(causal), dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code < 0:
        raise RuntimeError(f"{entry} failed: cuTensorMapEncodeTiled returned "
                           f"CUresult {-code}")
    if code:
        msg = getattr(lib, f"{entry}_error_string")(code).decode()
        raise RuntimeError(f"{entry} failed: cudaError {code} ({msg})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[route] += 1
    return out[..., :dh].contiguous() if width != dh else out


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = dict.fromkeys(ROUTES.values(), 0)
