"""The traced run's reading of torch.profiler's device trace.

The driver wraps its own calls in ``record_function`` ranges (its
``SPANS``, these where it names none). Each device operation (a kernel, a
copy or a fill) is given to the range in which the host launched it,
found through the launch's correlation id, so a metric follows the
driver's calls and not a kernel's name. The device is busy where any
operation runs; a gap between operations is put down to the range the
host was in when it began."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass

__all__ = ["SPANS", "TraceSummary", "summarize", "read_chrome_trace"]

SPANS = ("portbench.write", "portbench.read", "portbench.reset",
         "portbench.collect", "portbench.submit")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class TraceSummary:
    busy_s: float
    span_device_s: dict   # range -> seconds of the device operations it launched
    span_ops: dict        # range -> device operations it launched
    device_ops: list      # [[name, seconds]]: the operations that took most
    idle_gaps: list       # [[range, seconds]]: idle time by the host's range
    device_events: int


def read_chrome_trace(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, spans=SPANS) -> TraceSummary:
    """Reduce a chrome trace's events (times in microseconds)."""
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") in spans)
    starts = [r[0] for r in ranges]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            return ranges[i][2]
        return None

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    span_s, span_n = defaultdict(float), defaultdict(int)
    by_name = defaultdict(float)
    for e in device:
        dur = e.get("dur", 0) * 1e-6
        by_name[e["name"]] += dur
        t = launches.get(e.get("args", {}).get("correlation"))
        span = span_at(t) if t is not None else None
        if span is not None:
            span_s[span] += dur
            span_n[span] += 1
    merged = _merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps[span_at(a) or "host.other"] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        busy_s=busy, span_device_s=dict(span_s), span_ops=dict(span_n),
        device_ops=[[n[:120], s] for n, s in top],
        idle_gaps=[[n, s] for n, s in idle], device_events=len(device))
