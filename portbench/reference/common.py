"""What the family references share: the affine-trig map and the matmul
of a stated precision.

``tf32=True`` rounds both operands of a matmul to TF32 (10 mantissa bits,
to nearest even) and multiplies them in float32 with TF32 off: the
arithmetic of a tensor-core TF32 product, the same on any device. It is
the control's precision (one step below the configurations' float32)."""
from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["round_tf32", "matmul", "features", "exact_matmul"]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (ties to even)."""
    if t.dtype != torch.float32:
        raise TypeError(f"TF32 rounding takes float32, got {t.dtype}")
    i = t.contiguous().view(torch.int32)
    r = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return r.view(torch.float32).view(t.shape)


@contextlib.contextmanager
def exact_matmul():
    """TF32 off for the block (float32 products in float32)."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    with exact_matmul():
        return torch.matmul(a, b)


def features(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             tf32: bool = False) -> torch.Tensor:
    """``z(x) = sqrt(2 / D) cos(x W + b)`` (the paper's RFF map), in the
    dtype of ``w``."""
    dfeat = w.shape[1]
    return math.sqrt(2.0 / dfeat) * torch.cos(matmul(x.to(w.dtype), w, tf32)
                                              + b)
