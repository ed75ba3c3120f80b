"""Nestable wall-clock trace spans over a bounded ring buffer.

Counterpart of ``repro/obs/trace.py``. The serving stack (facade -> queue
-> snapshot -> kernel dispatch) is host-side and synchronous, so a plain
span stack gives an exact causal tree of every request: ``serve.submit``
contains ``queue.flush`` contains ``kernel.klms_chunk`` and
``snapshot.publish``.

* :class:`Tracer` — ``with tracer.span("serve.flush", tenant=3):`` records
  one completed :class:`Span` (name, start/end, attributes, parent id,
  depth) into a bounded ring buffer. Overflow drops the *oldest* spans and
  counts them (``dropped``); both exports carry a ``truncated`` flag.
* Exports: :meth:`Tracer.to_jsonl` (one JSON object per span) and
  :meth:`Tracer.to_chrome_trace` (Chrome trace-event JSON, loadable at
  ``chrome://tracing`` or https://ui.perfetto.dev).
* Instant events (:meth:`Tracer.instant`) for the probe tier's degradation
  events — zero-duration marks on the same timeline.
* The profiler bridge: while ``torch.profiler`` records, every span also
  enters ``torch.profiler.record_function(name)``, so the program's spans
  land in the profiler's trace as ``user_annotation`` ranges on the clock
  of the device's operations. Without a tracer the ambient :func:`span`
  enters that range alone: an operator who runs ``torch.profiler`` sees
  the program's layers without building a :class:`Tracer`.
  ``jax_annotations=`` is ``repro``'s keyword, accepted and ignored.
  Each such range also adds its host time to :func:`profiled_spans`,
  keyed by its nesting path (the names of the profiled spans open around
  it, outermost first), so whoever ran a profiled window reads the
  program's layers on its own clock without parsing the trace.

Spans read the host clock and never synchronize the device: a span around
a kernel launch measures the enqueue, not the kernel.

The **active-tracer stack** lets instrumentation deep in the stack emit
spans without a tracer in every signature: the facade activates its
tracer around each request (``with activate(tracer):``) and the
module-level :func:`span` / :func:`instant` helpers do nothing (a list
check and the profiler's flag) when no tracer is active and the profiler
is off; :func:`recording` says whether a span would be recorded, so a
caller builds its attributes only then. Like the queue, the stack is
single-threaded state.

:func:`host_wait` marks a place where the host blocks on the device (a
``host.wait`` span, attribute ``site``) and counts it under
``host.device_waits{site=...}`` in ``obs.telemetry``.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.obs import telemetry as _telemetry

__all__ = [
    "Span",
    "Tracer",
    "activate",
    "clear_profiled_spans",
    "current_tracer",
    "host_wait",
    "instant",
    "profiled_spans",
    "recording",
    "span",
]

# Whether torch.profiler is recording on this thread (~0.2 us a call).
_profiling = torch._C._autograd._profiler_enabled

# The profiled spans open now (names, outermost first) and, by nesting
# path, the count and host seconds of those that closed.
_OPEN: list[str] = []
_TOTALS: dict[tuple, list] = {}


class _Profiled:
    """A ``record_function`` range that adds its host time to
    :func:`profiled_spans` under its nesting path."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        _OPEN.append(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        try:
            self._rf.__exit__(*exc)
        finally:
            path = tuple(_OPEN)
            _OPEN.pop()
            agg = _TOTALS.get(path)
            if agg is None:
                agg = _TOTALS[path] = [0, 0.0]
            agg[0] += 1
            agg[1] += dt
        return False


def profiled_spans() -> dict:
    """``{nesting path: (count, host seconds)}`` of the spans that closed
    while the profiler recorded, since the process began or
    :func:`clear_profiled_spans`; a path is the tuple of the span's name
    and the names of the profiled spans around it, outermost first."""
    return {path: tuple(agg) for path, agg in _TOTALS.items()}


def clear_profiled_spans() -> None:
    """Forget the totals of :func:`profiled_spans`."""
    _TOTALS.clear()


class Span:
    """One completed (or still-open) trace span."""

    __slots__ = (
        "name", "span_id", "parent_id", "depth", "t0", "t1", "attrs", "kind",
    )

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 depth: int, t0: float, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.depth = depth
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.kind = "span"

    @property
    def duration(self) -> float:
        """Seconds (0.0 while still open and for instant events)."""
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "depth": self.depth,
            "ts_us": round(self.t0 * 1e6, 3),
            "dur_us": round(self.duration * 1e6, 3),
            "kind": self.kind,
            "attrs": self.attrs,
        }


class Tracer:
    """Span recorder with a bounded ring buffer and stable exports.

    Args:
      capacity: completed spans/events kept; older ones are dropped (and
        counted in :attr:`dropped` / the exports' ``truncated`` flag).
      clock: injectable monotonic clock in seconds (tests pass a fake).
      jax_annotations: ``repro``'s keyword, accepted for its callers; the
        profiler bridge follows the profiler (every span enters
        ``torch.profiler.record_function`` while it records).
    """

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter,
                 jax_annotations: bool = False):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._origin = clock()
        self._done: deque[Span] = deque()
        self._stack: list[Span] = []
        self._next_id = 0
        self.dropped = 0
        del jax_annotations

    # -- recording ---------------------------------------------------------

    def _now(self) -> float:
        return self._clock() - self._origin

    def _record(self, sp: Span) -> None:
        if len(self._done) >= self.capacity:
            self._done.popleft()
            self.dropped += 1
        self._done.append(sp)

    def _open(self, name: str, attrs: dict) -> Span:
        parent = self._stack[-1] if self._stack else None
        sp = Span(name, self._next_id,
                  parent.span_id if parent is not None else None,
                  len(self._stack), self._now(), attrs)
        self._next_id += 1
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Open a nested span; attributes may be amended on the yielded
        object (``sp.attrs["ticks"] = n``) before it closes."""
        sp = self._open(name, attrs)
        self._stack.append(sp)
        try:
            if _profiling():
                with _Profiled(name):
                    yield sp
            else:
                yield sp
        finally:
            sp.t1 = self._now()
            self._stack.pop()
            self._record(sp)

    def instant(self, name: str, **attrs: Any) -> Span:
        """Record a zero-duration event at the current nesting depth."""
        sp = self._open(name, attrs)
        sp.t1 = sp.t0
        sp.kind = "instant"
        self._record(sp)
        return sp

    # -- introspection -----------------------------------------------------

    def spans(self) -> list[Span]:
        """Completed spans/events, oldest first (close order for spans)."""
        return list(self._done)

    @property
    def truncated(self) -> bool:
        """True iff ring overflow has dropped at least one span."""
        return self.dropped > 0

    def summary(self) -> dict:
        """Aggregate view for ``Server.observability()``: span counts and
        total wall time by name, plus buffer health."""
        by_name: dict[str, dict] = {}
        for sp in self._done:
            agg = by_name.setdefault(
                sp.name, {"count": 0, "total_us": 0.0, "events": 0}
            )
            if sp.kind == "instant":
                agg["events"] += 1
            else:
                agg["count"] += 1
                agg["total_us"] += sp.duration * 1e6
        for agg in by_name.values():
            agg["total_us"] = round(agg["total_us"], 3)
        return {
            "spans": len(self._done),
            "dropped": self.dropped,
            "truncated": self.truncated,
            "open": len(self._stack),
            "by_name": dict(sorted(by_name.items())),
        }

    # -- exports -----------------------------------------------------------

    def to_jsonl(self, path: Optional[str] = None) -> str:
        """One JSON object per completed span, oldest first. The first
        line is a header carrying the buffer-truncation contract."""
        header = {
            "kind": "header",
            "spans": len(self._done),
            "dropped": self.dropped,
            "truncated": self.truncated,
        }
        lines = [json.dumps(header)]
        lines += [json.dumps(sp.to_dict()) for sp in self._done]
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): spans become
        complete (``ph: "X"``) events with microsecond ``ts``/``dur``,
        instants ``ph: "i"`` marks; ``tid`` is the span depth."""
        events = []
        for sp in self._done:
            ev = {
                "name": sp.name,
                "cat": sp.name.split(".", 1)[0],
                "pid": 1,
                "tid": sp.depth,
                "ts": round(sp.t0 * 1e6, 3),
                "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
            }
            if sp.kind == "instant":
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = round(sp.duration * 1e6, 3)
            events.append(ev)
        payload = {
            "displayTimeUnit": "ms",
            "traceEvents": events,
            "otherData": {
                "dropped": self.dropped,
                "truncated": self.truncated,
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
        return payload


def _jsonable(v: Any):
    """Attribute values must survive json.dump: anything exotic (a dtype,
    a device) becomes its string."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


# ---------------------------------------------------------------------------
# Active-tracer stack: how deep layers emit spans without API threading.
# ---------------------------------------------------------------------------

_ACTIVE: list[Tracer] = []
_NULL = contextlib.nullcontext()


def current_tracer() -> Optional[Tracer]:
    """The innermost active tracer, or None (the untraced fast path)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def activate(tracer: Optional[Tracer]) -> Iterator[None]:
    """Make ``tracer`` the ambient tracer for the dynamic extent
    (re-entrant; ``activate(None)`` does nothing)."""
    if tracer is None:
        yield
        return
    _ACTIVE.append(tracer)
    try:
        yield
    finally:
        _ACTIVE.pop()


def recording() -> bool:
    """Whether :func:`span` records anything: a tracer is active or the
    profiler records."""
    return bool(_ACTIVE) or _profiling()


def span(name: str, **attrs: Any):
    """Span on the ambient tracer; without one, a ``record_function`` range
    while the profiler records, else a reusable null context."""
    if _ACTIVE:
        return _ACTIVE[-1].span(name, **attrs)
    if _profiling():
        return _Profiled(name)
    return _NULL


def host_wait(site: str):
    """Count one blocking wait of the host on the device at ``site``
    (``host.device_waits{site=...}``) and return its ``host.wait`` span."""
    _telemetry.record_device_wait(site)
    return span("host.wait", site=site)


def instant(name: str, **attrs: Any) -> Optional[Span]:
    """Instant event on the ambient tracer (None when inactive)."""
    t = current_tracer()
    if t is None:
        return None
    return t.instant(name, **attrs)
