"""Deprecated lockstep serving entry points (pre-facade names).

Counterpart of ``repro/serve/bank_loop.py``: ``make_bank_server`` /
``make_krls_bank_server``, ``serve_bank_stream`` /
``serve_krls_bank_stream`` and ``reset_tenants`` / ``reset_krls_tenants``
are thin shims over the facade in ``serve/api.py``
(:func:`~repro_torch.serve.make_tick`,
:func:`~repro_torch.serve.run_stream`,
:func:`~repro_torch.serve.reset_slots`). Each keeps ``repro``'s signature,
returns its facade call's result bit for bit and emits one
:class:`DeprecationWarning` per process. New code calls the facade.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.klms import LMSState, StepOut
from repro_torch.core.krls import RLSState
from repro_torch.features.base import FeatureLike

__all__ = [
    "make_bank_server",
    "serve_bank_stream",
    "reset_tenants",
    "make_krls_bank_server",
    "serve_krls_bank_stream",
    "reset_krls_tenants",
]


def make_bank_server(
    rff: FeatureLike, mu: Union[float, torch.Tensor], mode: str = "auto"
) -> Callable[[LMSState, torch.Tensor, torch.Tensor],
              tuple[LMSState, StepOut]]:
    """Deprecated: use ``repro_torch.serve.make_tick("klms", ...)``."""
    from repro_torch.serve import api

    api._deprecated("make_bank_server", 'make_tick("klms", ...)')
    return api.make_tick("klms", rff, mode=mode, mu=mu)


def serve_bank_stream(
    rff: FeatureLike,
    xs: torch.Tensor,
    ys: torch.Tensor,
    mu: Union[float, torch.Tensor],
    state: Optional[LMSState] = None,
    mode: str = "auto",
    chunk: Optional[int] = None,
) -> tuple[LMSState, StepOut]:
    """Deprecated: use ``repro_torch.serve.run_stream("klms", ...)``."""
    from repro_torch.serve import api

    api._deprecated("serve_bank_stream", 'run_stream("klms", ...)')
    return api.run_stream("klms", rff, xs, ys, state=state, mode=mode,
                          chunk=chunk, mu=mu)


def reset_tenants(state: LMSState, slots) -> LMSState:
    """Deprecated: use ``repro_torch.serve.reset_slots(state, slots)``."""
    from repro_torch.serve import api

    api._deprecated("reset_tenants", "reset_slots(state, slots)")
    return api.reset_slots(state, slots, learner="klms")


def make_krls_bank_server(
    rff: FeatureLike, beta: Union[float, torch.Tensor] = 0.9995,
    mode: str = "auto",
) -> Callable[[RLSState, torch.Tensor, torch.Tensor],
              tuple[RLSState, StepOut]]:
    """Deprecated: use ``repro_torch.serve.make_tick("krls", ...)``."""
    from repro_torch.serve import api

    api._deprecated("make_krls_bank_server", 'make_tick("krls", ...)')
    return api.make_tick("krls", rff, mode=mode, beta=beta)


def serve_krls_bank_stream(
    rff: FeatureLike,
    xs: torch.Tensor,
    ys: torch.Tensor,
    lam: float = 1e-4,
    beta: Union[float, torch.Tensor] = 0.9995,
    state: Optional[RLSState] = None,
    mode: str = "auto",
    chunk: Optional[int] = None,
) -> tuple[RLSState, StepOut]:
    """Deprecated: use ``repro_torch.serve.run_stream("krls", ...)``."""
    from repro_torch.serve import api

    api._deprecated("serve_krls_bank_stream", 'run_stream("krls", ...)')
    return api.run_stream("krls", rff, xs, ys, state=state, mode=mode,
                          chunk=chunk, lam=lam, beta=beta)


def reset_krls_tenants(state: RLSState, slots,
                       lam: float = 1e-4) -> RLSState:
    """Deprecated: use ``repro_torch.serve.reset_slots(..., lam=lam)``."""
    from repro_torch.serve import api

    api._deprecated("reset_krls_tenants",
                    'reset_slots(state, slots, learner="krls")')
    return api.reset_slots(state, slots, learner="krls", lam=lam)
