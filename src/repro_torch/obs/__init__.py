"""Observability: trace spans, dispatch telemetry, numerics probes, faults.

Counterpart of ``repro/obs``, all host-side:

* :mod:`repro_torch.obs.trace` — nestable wall-clock spans over a bounded
  ring buffer, JSONL and Chrome trace-event exports, and the active-tracer
  stack that the serve and kernel layers emit into;
* :mod:`repro_torch.obs.telemetry` — process-wide kernel-dispatch counters
  and bytes-moved gauges;
* :mod:`repro_torch.obs.probes` — numerics taps (finiteness, norms, KRLS
  P drift), the bf16 read-contract probe and the threshold monitor;
* :mod:`repro_torch.obs.faults` — seeded fault injection at flush
  boundaries, one kind a probe (the recovery tier's tests drive
  ``serve/recovery.py`` through it).

Wired through ``repro_torch.serve.make_server(trace=..., probe=...)`` and
exported by ``Server.observability()``.
"""
from repro_torch.obs.trace import (
    Span,
    Tracer,
    activate,
    current_tracer,
    instant,
    span,
)
from repro_torch.obs.probes import (
    DEFAULT_THRESHOLDS,
    DegradationEvent,
    ProbeMonitor,
    bf16_read_error,
    slot_stats,
    stats_tap,
)
from repro_torch.obs import telemetry
from repro_torch.obs.faults import FAULT_KINDS, Fault, FaultInjector, FaultPlan

__all__ = [
    "Span",
    "Tracer",
    "activate",
    "current_tracer",
    "instant",
    "span",
    "DEFAULT_THRESHOLDS",
    "DegradationEvent",
    "ProbeMonitor",
    "bf16_read_error",
    "slot_stats",
    "stats_tap",
    "telemetry",
    "FAULT_KINDS",
    "Fault",
    "FaultInjector",
    "FaultPlan",
]
