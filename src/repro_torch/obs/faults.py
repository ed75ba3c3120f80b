"""Deterministic fault injection for the serving stack's recovery loop.

Counterpart of ``repro/obs/faults.py``. The probes (obs/probes.py) detect
degraded state and serve/recovery.py repairs it; this module makes every
failure mode that loop watches for, on demand and reproducibly:

* ``nan_state`` — poison one tenant's state with NaN (the ``finite``
  probe's target).
* ``asym_pmat`` — push a KRLS P off symmetric by a relative delta (the
  ``pmat.asym_rel`` probe's target). A family without a true ``(D, D)`` P
  gets an Inf poison instead (``effective="nonfinite"``).
* ``log_corrupt`` — overwrite one ReplayLog entry with NaN *and* poison
  the tenant's state: ``finite`` fires, and the ladder's rebuild rung must
  see the corrupt log and fall through to reset.
* ``drop_flush`` — silently discard a tenant's pending backlog (the
  ``ticks_lag`` probe's target: arrivals acknowledged, never trained).
* ``clock_skew`` — offset the snapshot tier's clock (the ``clock_skew``
  probe's target).

Faults are declared in a :class:`FaultPlan` (each pinned to a tenant and a
flush index) and applied by a :class:`FaultInjector` that wraps the
snapshot tier's ``flush``, the boundary the probes sample at. A fault
replaces the live state with a corrupted *copy*: the published read
replica, which the quarantine serves from, keeps its rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs import trace as _trace

__all__ = ["FAULT_KINDS", "Fault", "FaultPlan", "FaultInjector"]

FAULT_KINDS = (
    "nan_state",
    "asym_pmat",
    "log_corrupt",
    "drop_flush",
    "clock_skew",
)


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` hits ``tenant`` just before the
    ``at_flush``-th flush the injector observes (0-based).

    ``magnitude`` is the relative off-symmetric delta for ``asym_pmat``
    (default 0.05, five times the default ``pmat.asym_rel`` threshold) and
    the clock offset in seconds for ``clock_skew`` (which ignores
    ``tenant``).
    """

    kind: str
    tenant: int
    at_flush: int
    magnitude: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick from {FAULT_KINDS}"
            )


@dataclass
class FaultPlan:
    """An ordered, deterministic set of :class:`Fault` declarations."""

    faults: list = field(default_factory=list)

    def due(self, flush_idx: int) -> list:
        """Faults scheduled for the given flush index, in plan order."""
        return [f for f in self.faults if f.at_flush == flush_idx]

    def kinds(self) -> list:
        return [f.kind for f in self.faults]

    @classmethod
    def random(cls, seed: int, tenants: int, *, n: int = 3,
               kinds=FAULT_KINDS, flush_lo: int = 1, flush_hi: int = 8,
               magnitude: float = 0.05) -> "FaultPlan":
        """A seed-deterministic plan (``repro``'s draws): ``n`` faults
        uniform over ``kinds`` x ``[0, tenants)`` x ``[flush_lo,
        flush_hi)``."""
        rng = np.random.default_rng(seed)
        faults = [
            Fault(
                kind=str(rng.choice(list(kinds))),
                tenant=int(rng.integers(0, tenants)),
                at_flush=int(rng.integers(flush_lo, flush_hi)),
                magnitude=magnitude,
            )
            for _ in range(n)
        ]
        return cls(faults=faults)


def _is_rls_bank(state) -> bool:
    """A true RLS bank: a (B, D, D) ``pmat`` beside a theta row, not a
    dictionary state that carries a P block."""
    return hasattr(state, "pmat") and not hasattr(state, "centers")


def _poison_leaf(state, slot: int, value: float):
    """A copy of ``state`` whose first float leaf named theta / coeffs /
    alpha (else its first float leaf) has row ``slot`` set to ``value``;
    the other leaves are shared, the input is untouched."""
    target = None
    for i, (name, leaf) in enumerate(zip(state._fields, state)):
        if not leaf.is_floating_point():
            continue
        if "theta" in name or "coeffs" in name or "alpha" in name:
            target = i
            break
        if target is None:
            target = i
    if target is None:  # pragma: no cover - states always carry floats
        raise ValueError("state has no float leaf to poison")
    leaves = list(state)
    leaves[target] = leaves[target].clone()
    leaves[target][slot] = value
    return type(state)(*leaves)


class FaultInjector:
    """Apply a :class:`FaultPlan` to a live ``serve.api.Server`` at its
    flush boundaries.

    ``attach()`` shadows the snapshot tier's ``flush`` on the instance
    (``detach()`` restores it); every wrapped call first applies the faults
    due at the current flush index, then runs the real flush, so the
    corrupted state is trained on and tapped in the same flush. ``applied``
    records what happened (kind, tenant, slot, flush index, and the
    effective corruption).
    """

    def __init__(self, server, plan: FaultPlan):
        self.server = server
        self.plan = plan
        self.flushes = 0
        self.applied: list[dict] = []
        self._orig_flush = None
        self._orig_clock = None

    # -- lifecycle ----------------------------------------------------------

    def attach(self) -> "FaultInjector":
        if self._orig_flush is not None:
            raise RuntimeError("injector already attached")
        inner = self.server.snapshot_server
        orig = inner.flush

        def flush_with_faults():
            for fault in self.plan.due(self.flushes):
                self._apply(fault)
            self.flushes += 1
            return orig()

        self._orig_flush = orig
        inner.flush = flush_with_faults
        return self

    def detach(self) -> None:
        if self._orig_flush is None:
            return
        inner = self.server.snapshot_server
        if inner.__dict__.get("flush") is not None:
            del inner.flush
        self._orig_flush = None
        if self._orig_clock is not None:
            inner._clock = self._orig_clock
            self._orig_clock = None

    # -- application --------------------------------------------------------

    def _slot_of(self, tenant: int) -> Optional[int]:
        return self.server.resident.get(tenant)

    def _apply(self, fault: Fault) -> None:
        record = {
            "kind": fault.kind,
            "tenant": fault.tenant,
            "flush": self.flushes,
            "effective": fault.kind,
        }
        if fault.kind == "clock_skew":
            self._skew_clock(fault.magnitude)
        else:
            slot = self._slot_of(fault.tenant)
            if slot is None:
                # Not resident: nothing in the bank to corrupt.
                record["effective"] = "skipped_cold"
                self.applied.append(record)
                return
            record["slot"] = slot
            if fault.kind == "nan_state":
                self._poison_state(slot, float("nan"))
            elif fault.kind == "asym_pmat":
                if not self._flip_asym(slot, fault.magnitude):
                    self._poison_state(slot, float("inf"))
                    record["effective"] = "nonfinite"
            elif fault.kind == "log_corrupt":
                self._corrupt_log(fault.tenant)
                self._poison_state(slot, float("nan"))
            elif fault.kind == "drop_flush":
                queue = self.server.queue
                record["dropped"] = len(queue._pending[slot])
                queue._pending[slot].clear()
        _trace.instant("fault.injected", **record)
        self.applied.append(record)

    def _poison_state(self, slot: int, value: float) -> None:
        queue = self.server.queue
        queue.state = _poison_leaf(queue.state, slot, value)

    def _flip_asym(self, slot: int, magnitude: float) -> bool:
        """Add an off-symmetric delta to a copy of P[slot]; False if the
        state has no RLS P."""
        queue = self.server.queue
        state = queue.state
        if not _is_rls_bank(state):
            return False
        scale = float(state.pmat[slot].abs().amax())
        pmat = state.pmat.clone()
        pmat[slot, 0, 1] += magnitude * max(scale, 1.0)
        queue.state = state._replace(pmat=pmat)
        return True

    def _corrupt_log(self, tenant: int) -> None:
        log = self.server.log
        buf = log._buf.get(tenant) if log is not None else None
        if not buf:
            return
        idx = len(buf) // 2
        x, y = buf[idx]
        buf[idx] = (np.full_like(x, np.nan), y)

    def _skew_clock(self, offset: float) -> None:
        inner = self.server.snapshot_server
        if self._orig_clock is None:
            self._orig_clock = inner._clock
        base = inner._clock
        inner._clock = lambda: base() + offset

