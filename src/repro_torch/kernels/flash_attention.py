"""Wrapper of the flash-attention kernels, one route a dtype.

``flash_attention_cuda`` replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``: exact softmax
attention on q, k ``(BH, S, dh)`` and v ``(BH, S, dv)`` (GQA kv repeated to
full heads upstream; dh and dv up to 256 and independent, as in
deepseek-v2-lite's MLA heads (192, 128), minicpm3's (96, 64) and
recurrentgemma's 256), f32 statistics inside, the output ``(BH, S, dv)`` in
q's type. It routes by dtype:

* bf16 -> ``csrc/flash_attention_sm90.cu``, the tensor-core kernel (wgmma
  products, TMA loads into a two-stage ring, P rounded to bf16 for P V),
  one launch for each 128 columns of V (:func:`flash_plan`'s passes);
* f32 -> ``csrc/flash_attention.cu``, the CUDA-core kernel in IEEE f32
  (f32 never runs on TF32 in this port): register tiles fed by 16-byte
  shared loads, K and V by cp.async, a query tile that :func:`flash_plan`
  picks from (dh, dv, S), one launch.

The wrapper checks its inputs, allocates the output, launches on the
current stream, raises on a non-zero return code and counts its launches
in ``.launches`` and, per route, in ``.route_launches``. CPU tensors are
refused (``kernels/ops.py`` routes them to the plain version).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.chunking import SMEM_BUDGET

__all__ = ["flash_attention_cuda", "flash_plan", "FlashPlan", "MAX_HEAD_DIM",
           "ROUTES", "CUDA_CORE_TILES", "cuda_core_smem_bytes"]

# Both kernels take q/k and v heads up to 256 columns: the CUDA-core
# kernel's accumulator is up to 32 columns a thread over its 8 column
# groups (at 64-row tiles), the tensor-core kernel pads q/k to one to four
# 64-column swizzle atoms and takes V 128 columns a launch.
MAX_HEAD_DIM = 256
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
V_PASS = 128  # V columns a tensor-core launch (kVPass in the source)
# The CUDA-core kernel's thread tiles, (query rows a block, rows a thread),
# 8 rows / thread_rows threads a block, and the widest V each takes
# (thread_rows x 4 TD4 accumulators a thread for dv <= 32 TD4, at most 16
# float4s); its 64-key tile.
CUDA_CORE_TILES = {(128, 8): 64, (128, 4): 128, (64, 2): 256}
CUDA_CORE_KEYS = 64
SM_SHARED = 233_472  # an SM's shared memory; each block reserves 1 KiB

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIBS = {
    "cuda_core": ("flash_attention", "flash_attention"),
    "tensor_core": ("flash_attention_sm90", "flash_attention_bf16"),
}
_ARGS = {
    # q, k, v, out, BH, S, dh, dv, causal, scale, rows, thread_rows, stream
    "cuda_core": (_P,) * 4 + (_I,) * 5 + (ctypes.c_float, _I, _I, _P),
    # q, k, v, out, BH, S, dh, dv, v_col0, v_cols, causal, scale, stream
    "tensor_core": (_P,) * 4 + (_I,) * 7 + (ctypes.c_float, _P),
}


class FlashPlan(NamedTuple):
    """How the card runs one call (:func:`flash_plan`)."""

    route: str
    source: str
    entry: str
    width: int      # q/k head width the kernel sees (bf16: padded to 8)
    v_width: int    # v head width the kernel sees (bf16: padded to 8)
    key_tile: int   # keys a tile
    passes: tuple   # (first V column, columns) of each launch
    smem_bytes: int  # dynamic shared memory of one block
    query_tile: int  # query rows a block
    thread_rows: int  # query rows a thread (CUDA cores; the bf16 route 0)


def _qk_ld(width: int) -> int:
    """The CUDA-core kernel's row stride of its Q and K tiles: the width,
    or 4 more where width / 4 is even (``qk_ld`` in the source)."""
    return width if (width // 4) % 2 else width + 4


def _smem_bytes(route: str, width: int, v_width: int, key_tile: int,
                query_tile: int) -> int:
    """The block's shared memory, as laid out in the two sources."""
    if route == "cuda_core":  # Q, K, V, P (72-float rows)
        ld = _qk_ld(width)
        return 4 * (query_tile * ld + key_tile * (ld + v_width)
                    + query_tile * (key_tile + 8))
    hd = -(-width // 64) * 64
    dv = 64 if v_width <= 64 else V_PASS
    return 256 * hd + 2 * key_tile * (2 * hd + 2 * dv) + 40 + 1024


def _cuda_core_tile(width: int, v_width: int, slen: int) -> tuple[int, int]:
    """(query rows, rows a thread) of the CUDA-core kernel: the first of
    :data:`CUDA_CORE_TILES` whose accumulators take the V head and whose
    block fits :data:`SMEM_BUDGET`, 128 rows only where S passes one
    64-row tile (each K and V tile then serves twice the rows). The
    128-thread tile (8 rows a thread) runs only where two blocks fit an SM
    (one block of 4 warps leaves the FMA units idle)."""
    for (rows, thread_rows), v_cap in CUDA_CORE_TILES.items():
        if v_width > v_cap or (rows == 128 and slen <= 64):
            continue
        smem = _smem_bytes("cuda_core", width, v_width, CUDA_CORE_KEYS, rows)
        if thread_rows == 8 and 2 * (smem + 1024) > SM_SHARED:
            continue
        if smem <= SMEM_BUDGET:
            return rows, thread_rows
    return 64, 2


def flash_plan(q, k, v) -> FlashPlan:
    """Check q, k, v (the device aside) and say how the card runs them.
    bf16 goes to the tensor-core kernel with dh and dv each padded to a
    multiple of 8 (TMA reads rows of a multiple of 16 bytes; zero columns
    change neither the scores nor the kept outputs), 128-key tiles up to a
    padded dh of 192 and 64-key tiles above (the ring's shared memory), one
    launch per 128 columns of V; f32 to the CUDA-core kernel with dh and
    dv each padded to a multiple of 4 (its 16-byte copies), 64-key tiles,
    the query tile of :func:`_cuda_core_tile` and one launch. Raises where
    a kernel cannot take the shapes."""
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, S, dh), got shape {tuple(q.shape)}")
    if q.dtype not in ROUTES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    bh, slen, dh = q.shape
    dv = v.shape[-1] if v.ndim == 3 else -1
    for name, t, shape in (("q", q, (bh, slen, dh)), ("k", k, (bh, slen, dh)),
                           ("v", v, (bh, slen, dv))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, width in (("head dim", dh), ("v head dim", dv)):
        if not 1 <= width <= MAX_HEAD_DIM:
            raise ValueError(f"{name} {width} outside [1, {MAX_HEAD_DIM}]")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the grid's 65535 heads")
    route = ROUTES[q.dtype]
    if route == "tensor_core":
        width, v_width = dh + -dh % 8, dv + -dv % 8
        key_tile = 128 if width <= 192 else 64
        passes = tuple((c0, min(V_PASS, v_width - c0))
                       for c0 in range(0, v_width, V_PASS))
        rows, thread_rows = 128, 0
    else:
        width, v_width = dh + -dh % 4, dv + -dv % 4
        key_tile, passes = CUDA_CORE_KEYS, ((0, v_width),)
        rows, thread_rows = _cuda_core_tile(width, v_width, slen)
    smem = _smem_bytes(route, width, v_width, key_tile, rows)
    if smem > SMEM_BUDGET:
        raise ValueError(f"dh={dh}, dv={dv}: {smem} bytes of shared memory "
                         f"exceed a block's {SMEM_BUDGET}")
    return FlashPlan(route, *_LIBS[route], width, v_width, key_tile, passes,
                     smem, rows, thread_rows)


def _lib(route: str):
    source, entry = _LIBS[route]
    extra = ({"flash_attention_smem_bytes": (_I,) * 3}
             if route == "cuda_core" else {})
    lib = _build.load(source, {entry: _ARGS[route],
                               f"{entry}_error_string": (_I,), **extra})
    getattr(lib, f"{entry}_error_string").restype = ctypes.c_char_p
    if extra:
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def cuda_core_smem_bytes(rows: int, width: int, v_width: int) -> int:
    """The CUDA-core kernel's own dynamic shared memory of one block (for
    a check that :func:`_smem_bytes` mirrors the source)."""
    return _lib("cuda_core").flash_attention_smem_bytes(rows, width, v_width)


def _aligned(t):
    """t itself, or a fresh copy when its address is not 16-byte aligned
    (TMA and cp.async read from 16-byte aligned rows)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(lib, entry: str, code: int) -> None:
    if code < 0:
        raise RuntimeError(f"{entry} failed: cuTensorMapEncodeTiled returned "
                           f"CUresult {-code}")
    if code:
        msg = getattr(lib, f"{entry}_error_string")(code).decode()
        raise RuntimeError(f"{entry} failed: cudaError {code} ({msg})")


def flash_attention_cuda(q, k, v, *, causal=True):
    """Softmax attention on the card: q, k (BH, S, dh), v (BH, S, dv), all
    f32 or all bf16, contiguous, dh and dv <= 256 -> (BH, S, dv) in q's
    type."""
    if q.device.type != "cuda":
        raise ValueError(
            "the CUDA flash-attention kernel takes CUDA tensors; use "
            f"mode='ref' (or 'auto') for tensors on {q.device}"
        )
    plan = flash_plan(q, k, v)
    bh, slen, dh = q.shape
    dv = v.shape[-1]
    if bh == 0 or slen == 0:
        return q.new_empty((bh, slen, dv))
    if plan.width != dh:
        q, k = (F.pad(t, (0, plan.width - dh)) for t in (q, k))
    if plan.v_width != dv:
        v = F.pad(v, (0, plan.v_width - dv))
    out = q.new_empty((bh, slen, plan.v_width))
    lib = _lib(plan.route)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = getattr(lib, plan.entry)
    q, k, v = (_aligned(t) for t in (q, k, v))
    if plan.route == "cuda_core":
        _raise_on(lib, plan.entry, fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            slen, plan.width, plan.v_width, int(causal), dh ** -0.5,
            plan.query_tile, plan.thread_rows, stream))
    else:
        for c0, cols in plan.passes:
            _raise_on(lib, plan.entry, fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                slen, plan.width, plan.v_width, c0, cols, int(causal),
                dh ** -0.5, stream))
    launches = len(plan.passes)
    flash_attention_cuda.launches += launches
    flash_attention_cuda.route_launches[plan.route] += launches
    return out[..., :dv].contiguous() if plan.v_width != dv else out


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = dict.fromkeys(ROUTES.values(), 0)
