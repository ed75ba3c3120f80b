"""The traced run's reading of the program's own spans.

While torch.profiler records, ``repro_torch``'s spans (those whose names
begin with the family's prefixes; the bank's ``PREFIXES``: the lockstep
tier's calls, the kernel ops, the host's waits on the device) enter
``record_function`` ranges, so they stand in the same chrome trace as the
driver's ranges (``tracing.SPANS`` by default) and the device's operations,
on one clock. This reader nests all of those ranges (one host thread
issues them) and gives, for each range name: how many there were, their
time, their self time (less the ranges nested directly in them), the time
of each range name nested anywhere inside them, the device time of the
operations launched inside them (by correlation id) and the device's idle
time in gaps that begin inside them. Each idle gap is also put down to
the innermost range open at its start (``host.other`` outside any). The
harness hands a traced window's events here with its driver's ranges and
its family's prefixes, and keeps the result on ``Run.program``.

The program also keeps, while the profiler records, the count and host
time of its spans by nesting path (``repro_torch.obs.trace.
profiled_spans``). The harness's profiler records only in the traced
window, so after that window :func:`program_spans` reads the window's
spans; the ``program_span`` metrics read them through :class:`SpanTotals`.

A program without these spans leaves only the harness's ranges: the
metrics that read a program span then find nothing and return None."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

from portbench import tracing

__all__ = ["PREFIXES", "ProgramTrace", "SpanTotals", "program_spans",
           "summarize"]

PREFIXES = ("lockstep.", "kernel.", "host.")


@dataclass
class ProgramTrace:
    spans: dict      # name -> count, total_s, self_s, device_s, idle_s
    within: dict     # outer name -> {inner name: seconds of inner inside outer}
    idle_gaps: list  # [[innermost range at the gap's start, seconds]]

    def per_call_ms(self, name: str, seconds: float):
        """``seconds`` over the count of ``name``, in ms; None where the
        trace has no such range."""
        n = self.spans.get(name, {}).get("count", 0)
        return seconds / n * 1e3 if n else None


def _ranges(events, spans, prefixes):
    keep = [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and (e.get("name") in spans
                 or e.get("name", "").startswith(tuple(prefixes)))]
    keep.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    starts = [e["ts"] for e in keep]
    ends = [e["ts"] + e.get("dur", 0) for e in keep]
    names = [e["name"] for e in keep]
    parent, stack = [], []
    for i, t in enumerate(starts):
        while stack and ends[stack[-1]] <= t:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return starts, ends, names, parent


def summarize(events: list, spans=tracing.SPANS,
              prefixes=PREFIXES) -> ProgramTrace:
    """Reduce a chrome trace's events (times in microseconds): the ranges
    named in ``spans`` and those whose names begin with one of
    ``prefixes``."""
    starts, ends, names, parent = _ranges(events, spans, prefixes)

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ends[i] < t:
            i = parent[i]
        return i

    def enclosing(i):
        out = set()
        while i >= 0:
            out.add(names[i])
            i = parent[i]
        return out

    stats = defaultdict(lambda: {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                 "device_s": 0.0, "idle_s": 0.0})
    within = defaultdict(lambda: defaultdict(float))
    for i, name in enumerate(names):
        dur = (ends[i] - starts[i]) * 1e-6
        s = stats[name]
        s["count"] += 1
        s["total_s"] += dur
        s["self_s"] += dur
        if parent[i] >= 0:
            stats[names[parent[i]]]["self_s"] -= dur
        for outer in enclosing(parent[i]) - {name}:
            within[outer][name] += dur

    launches = {}
    for e in events:
        if (e.get("cat") in tracing.LAUNCH_CATS
                and "correlation" in e.get("args", {})):
            launches[e["args"]["correlation"]] = e["ts"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS]
    for e in device:
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is not None:
            for name in enclosing(innermost(t)):
                stats[name]["device_s"] += e.get("dur", 0) * 1e-6

    merged = tracing._merged((e["ts"], e["ts"] + e.get("dur", 0))
                             for e in device)
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gap = (b - a) * 1e-6
        i = innermost(a)
        gaps[names[i] if i >= 0 else "host.other"] += gap
        for name in enclosing(i):
            stats[name]["idle_s"] += gap
    return ProgramTrace(
        spans=dict(stats), within={k: dict(v) for k, v in within.items()},
        idle_gaps=sorted(([n, s] for n, s in gaps.items()),
                         key=lambda kv: -kv[1]))


class SpanTotals:
    """The program's profiled spans, ``{nesting path: (count, seconds)}``
    with each path its span's name and those of the spans around it,
    outermost first."""

    def __init__(self, totals: dict):
        self.totals = totals

    def count(self, name: str) -> int:
        return sum(c for path, (c, _) in self.totals.items()
                   if path[-1] == name)

    def seconds(self, name: str, inside: str = None) -> float:
        """Host seconds of the spans ``name``, of those nested at any depth
        in a span ``inside`` where it is given."""
        return sum(s for path, (_, s) in self.totals.items()
                   if path[-1] == name
                   and (inside is None or inside in path[:-1]))

    def per_call_ms(self, name: str, seconds: float):
        """``seconds`` over the count of ``name``, in ms; None where there
        is no such span."""
        n = self.count(name)
        return seconds / n * 1e3 if n else None


def program_spans():
    """The program's profiled spans as :class:`SpanTotals`, or None where
    the program keeps no such totals."""
    try:
        from repro_torch.obs.trace import profiled_spans
    except ImportError:
        return None
    return SpanTotals(profiled_spans())
