"""Carry ``repro``'s parameters and state across as numpy arrays.

Every function takes numpy arrays (``np.asarray`` of a JAX array, say) and
returns the port's objects on ``device``, so both packages can compute on
the same numbers without the port reproducing JAX's PRNG. Nothing here
imports ``repro`` or ``jax``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.klms import LMSState
from repro_torch.core.krls import RLSState
from repro_torch.features.base import TrigFeatures, uniform_trig_scale

__all__ = ["tensor", "trig_features", "lms_state", "rls_state", "to_numpy"]


def tensor(a, *, device="cuda", dtype=None) -> torch.Tensor:
    """A contiguous copy of numpy ``a`` on ``device`` (dtype kept unless
    given)."""
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device)).contiguous()


def trig_features(omega, bias, scale: Optional[np.ndarray] = None, *,
                  device="cuda") -> TrigFeatures:
    """``repro``'s ``TrigFeatures`` (or ``RFF`` when ``scale`` is None,
    which takes the uniform ``sqrt(2/D)`` scale) as the port's map."""
    dev = resolve_device(device)
    omega_t = tensor(omega, device=dev)
    if scale is None:
        scale_t = uniform_trig_scale(omega_t.shape[1], omega_t.dtype, dev)
    else:
        scale_t = tensor(scale, device=dev)
    return TrigFeatures(omega=omega_t, bias=tensor(bias, device=dev),
                        scale=scale_t)


def lms_state(theta, step, *, device="cuda") -> LMSState:
    """``repro``'s ``LMSState`` (a single filter or a bank) as the port's."""
    return LMSState(theta=tensor(theta, device=device),
                    step=tensor(step, device=device, dtype=torch.int32))


def rls_state(theta, pmat, step, *, device="cuda") -> RLSState:
    """``repro``'s ``RLSState`` (a single filter or a bank) as the port's."""
    return RLSState(theta=tensor(theta, device=device),
                    pmat=tensor(pmat, device=device),
                    step=tensor(step, device=device, dtype=torch.int32))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The reverse direction: a port tensor as a host numpy array."""
    return t.detach().cpu().numpy()
