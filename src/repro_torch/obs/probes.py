"""Numerics health probes and the host-side degradation monitor.

Counterpart of ``repro/obs/probes.py``. An online filter that silently went
non-finite, or whose KRLS P drifted off symmetric, keeps serving garbage
at full speed; these probes make the state's health observable:

* :func:`stats_tap` — one pass of reductions over the float leaves of a
  bank state, run by the micro-batch queue right after its chunk step
  (``MicroBatchQueue.attach_probe``). Its outputs are 0-d tensors that
  stay on the device until the serve facade folds them at a flush
  boundary, in one device-to-host copy. ``repro`` fuses the tap into its
  jitted flush program; here it is plain PyTorch reductions launched after
  the chunk kernel (no TPU kernel stands behind it). It reads the state
  and writes nothing, so a probed server is bit for bit an unprobed one.
* :func:`slot_stats` — the same quantities kept per slot, for the recovery
  tier's rare event path.
* :func:`bf16_read_error` — the read-contract probe: relative error of the
  bf16 read against the f32 read on a query block (two read launches).
* :class:`ProbeMonitor` — thresholds over the tap's numbers (plus
  staleness, ``ticks_lag`` and ``clock_skew`` from the facade). A breach
  raises a :class:`DegradationEvent`, a ``probe.degraded`` instant in the
  active trace and a ``probe.degraded{probe=...}`` count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.obs import trace as obtrace

__all__ = [
    "DEFAULT_THRESHOLDS",
    "DegradationEvent",
    "ProbeMonitor",
    "bf16_read_error",
    "slot_stats",
    "stats_tap",
]

_TINY = 1e-30


def _named_leaves(state):
    """``(name, tensor)`` pairs of a state NamedTuple, in field order."""
    return list(zip(state._fields, state))


def _abs_max(leaf, dim=None):
    """``max |leaf|`` (over ``dim``, all by default) from its max and min:
    no ``|leaf|`` temporary, and a NaN or an infinity anywhere gives a
    non-finite result."""
    if dim is None:
        return torch.maximum(leaf.amax(), -leaf.amin())
    return torch.maximum(leaf.amax(dim), -leaf.amin(dim))


def _asym(p, dim=None):
    """``max |P - P^T|`` with one ``P``-sized temporary."""
    diff = torch.sub(p, p.transpose(-1, -2))
    return diff.abs_().amax() if dim is None else diff.abs_().amax(dim)


def _cond_proxy(diag, dim=None):
    """``max diag / min positive diag``; zero diagonal entries are empty
    dictionary rows (ALD's unused capacity), and a diagonal with no
    positive entry gives 0."""
    pos = torch.where(diag > 0, diag, torch.full_like(diag, float("inf")))
    if dim is None:
        dmin_pos, dmax = pos.amin(), diag.amax()
    else:
        dmin_pos, dmax = pos.amin(dim), diag.amax(dim)
    return torch.where(torch.isinf(dmin_pos), torch.zeros_like(dmax),
                       dmax / (dmin_pos + _TINY))


def stats_tap(state) -> dict[str, torch.Tensor]:
    """Numerics reductions over a (bank) state: a flat dict of 0-d f32
    tensors on the state's device.

    * ``finite`` — 1.0 iff every float leaf is entirely finite;
    * ``<leaf>.max_abs`` — per float leaf;
    * ``theta.norm_max`` — largest per-row L2 norm of a ``theta`` leaf;
    * ``pmat.asym_rel`` — ``max|P - P^T| / max|P|`` over the bank;
    * ``pmat.diag_min`` / ``pmat.diag_max`` / ``pmat.cond_proxy`` — the
      spread of P's diagonal, a cheap conditioning-drift proxy.

    Integer leaves (step counters, dictionary sizes) are skipped.
    """
    stats: dict[str, torch.Tensor] = {}
    finite = torch.ones((), dtype=torch.bool, device=state[0].device)
    for name, leaf in _named_leaves(state):
        if not leaf.is_floating_point():
            continue
        leaf32 = leaf.float()
        max_abs = _abs_max(leaf32)
        finite = finite & torch.isfinite(max_abs)
        stats[f"{name}.max_abs"] = max_abs
        if name.endswith("theta") and leaf.ndim >= 1:
            norms = torch.sqrt(torch.sum(leaf32 * leaf32, dim=-1))
            stats["theta.norm_max"] = norms.amax()
        if name.endswith("pmat") and leaf.ndim >= 2:
            stats["pmat.asym_rel"] = _asym(leaf32) / (max_abs + _TINY)
            diag = torch.diagonal(leaf32, dim1=-2, dim2=-1).abs()
            stats["pmat.diag_min"] = diag.amin()
            stats["pmat.diag_max"] = diag.amax()
            stats["pmat.cond_proxy"] = _cond_proxy(diag)
    stats["finite"] = finite.float()
    return stats


def slot_stats(state) -> dict[str, torch.Tensor]:
    """Per-slot diagnostics for the recovery tier: ``(B,)`` f32 tensors
    ``finite`` (1.0 / 0.0 a slot), ``theta.norm`` (per-row L2 of a theta
    leaf) and, with a P leaf, ``pmat.asym_rel`` / ``pmat.cond_proxy``. The
    bank-wide tap stays the hot path; this pass runs only when an event
    has to be localized to a tenant."""
    leaves = _named_leaves(state)
    bsz = leaves[0][1].shape[0]
    stats: dict[str, torch.Tensor] = {}
    finite = torch.ones((bsz,), dtype=torch.bool, device=leaves[0][1].device)
    for name, leaf in leaves:
        if not leaf.is_floating_point():
            continue
        leaf32 = leaf.float()
        per_slot = leaf32.reshape(bsz, -1)
        max_abs = _abs_max(per_slot, 1)
        finite = finite & torch.isfinite(max_abs)
        if name.endswith("theta") and leaf.ndim >= 2:
            stats["theta.norm"] = torch.sqrt(
                torch.sum(leaf32 * leaf32, dim=-1))
        if name.endswith("pmat") and leaf.ndim >= 3:
            asym = _asym(leaf32, (-2, -1))
            stats["pmat.asym_rel"] = asym / (max_abs + _TINY)
            diag = torch.diagonal(leaf32, dim1=-2, dim2=-1).abs()
            stats["pmat.cond_proxy"] = _cond_proxy(diag, -1)
    stats["finite"] = finite.float()
    return stats


def bf16_read_error(state, feature_map, xq, *, mode: str = "auto") -> float:
    """Max relative error of the bf16 read against the f32 read on one
    ``(B, Q, d)`` query block (two read launches)."""
    from repro_torch.core.bank import bank_predict_block

    f32 = bank_predict_block(state, xq, feature_map, mode=mode,
                             precision=None).float()
    bf16 = bank_predict_block(state, xq, feature_map, mode=mode,
                              precision="bf16").float()
    denom = f32.abs().amax() + 1e-6
    return float((bf16 - f32).abs().amax() / denom)


@dataclass(frozen=True)
class DegradationEvent:
    """One threshold breach, structured for the trace and the export."""

    probe: str
    value: float
    threshold: float
    direction: str  # "above" | "below"
    tick: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "probe": self.probe,
            "value": self.value,
            "threshold": self.threshold,
            "direction": self.direction,
            "tick": self.tick,
        }


# probe -> ("max" breaches above, "min" breaches below), threshold value;
# repro's table. ``ticks_lag`` (acknowledged but never trained arrivals,
# from the facade's expected-ticks ledger) fires on any positive lag;
# ``clock_skew`` is off (inf) unless the recovery tier has a reference
# clock.
DEFAULT_THRESHOLDS: dict[str, tuple[str, float]] = {
    "finite": ("min", 1.0),
    "theta.norm_max": ("max", 1e6),
    "pmat.asym_rel": ("max", 1e-2),
    "pmat.cond_proxy": ("max", 1e12),
    "staleness_ticks": ("max", float("inf")),
    "bf16_read_error": ("max", 2e-2),
    "ticks_lag": ("max", 0.0),
    "clock_skew": ("max", float("inf")),
}


class ProbeMonitor:
    """Threshold monitor over :func:`stats_tap` outputs.

    Args:
      thresholds: overrides merged over :data:`DEFAULT_THRESHOLDS` — either
        ``{"name": value}`` (direction from the default table, "max" for
        unknown names) or ``{"name": ("min"|"max", value)}``.
      registry: optional ``MetricsRegistry`` receiving the
        ``probe.degraded{probe=...}`` counters.
      max_events: degradation events retained (older ones drop; the total
        count is kept).
    """

    def __init__(self, thresholds: Optional[dict] = None, registry=None,
                 max_events: int = 64):
        merged: dict[str, tuple[str, float]] = dict(DEFAULT_THRESHOLDS)
        for name, spec in (thresholds or {}).items():
            if isinstance(spec, tuple):
                direction, value = spec
            else:
                direction = DEFAULT_THRESHOLDS.get(name, ("max", 0.0))[0]
                value = spec
            merged[name] = (direction, float(value))
        self.thresholds = merged
        self.registry = registry
        self.max_events = max_events
        self.events: list[DegradationEvent] = []
        self.total_events = 0
        self.last_stats: dict[str, float] = {}
        self.last_tick: Optional[int] = None
        self.updates = 0
        self._subscribers: list[Callable[[DegradationEvent], None]] = []

    def subscribe(self, fn: Callable[[DegradationEvent], None]) -> None:
        """Register a callback run (synchronously, from ``update``) for
        every degradation event. A subscriber only records the event; the
        recovery tier acts after the update."""
        self._subscribers.append(fn)

    def _fire(self, ev: DegradationEvent) -> None:
        self.total_events += 1
        self.events.append(ev)
        if len(self.events) > self.max_events:
            self.events.pop(0)
        obtrace.instant("probe.degraded", **ev.to_dict())
        if self.registry is not None:
            self.registry.counter("probe.degraded", probe=ev.probe).inc()
        for fn in self._subscribers:
            fn(ev)

    def update(self, stats: dict[str, Any], *, tick: Optional[int] = None,
               staleness: Optional[int] = None,
               bf16_err: Optional[float] = None) -> list[DegradationEvent]:
        """Fold one tap readout (host floats, plus optional host-side
        probes) in; returns the degradation events it raised."""
        flat = {k: float(v) for k, v in stats.items()}
        if staleness is not None:
            flat["staleness_ticks"] = float(staleness)
        if bf16_err is not None:
            flat["bf16_read_error"] = float(bf16_err)
        self.last_stats = flat
        self.last_tick = tick
        self.updates += 1
        fired = []
        for name, value in flat.items():
            spec = self.thresholds.get(name)
            if spec is None:
                continue
            direction, bound = spec
            breached = value > bound if direction == "max" else value < bound
            if breached:
                ev = DegradationEvent(
                    probe=name, value=value, threshold=bound,
                    direction="above" if direction == "max" else "below",
                    tick=tick,
                )
                self._fire(ev)
                fired.append(ev)
        return fired

    def healthy(self) -> bool:
        """True iff no degradation event has ever fired."""
        return self.total_events == 0

    def state(self) -> dict:
        """JSON-able export for ``Server.observability()``."""
        return {
            "last": dict(self.last_stats),
            "last_tick": self.last_tick,
            "updates": self.updates,
            "healthy": self.healthy(),
            "total_events": self.total_events,
            "events": [ev.to_dict() for ev in self.events],
            "thresholds": {
                k: {"direction": d, "value": v}
                for k, (d, v) in sorted(self.thresholds.items())
                if v != float("inf")
            },
        }
