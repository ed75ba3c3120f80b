"""Serving metrics: counters, gauges and log-bucketed histograms.

A copy of ``repro/serve/metrics.py`` (pure Python, no framework). One
registry instruments one server; ``snapshot()`` renders it to a plain
dict. Labeled metrics are keyed ``name{k=v,...}``. Histograms use fixed
base-2 buckets on the float exponent (one ``math.frexp`` per observation)
and estimate percentiles by linear interpolation inside the winning
bucket, clamped to the exact observed ``[min, max]``.
"""
from __future__ import annotations

import math
from typing import Optional

__all__ = ["Counter", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Geometric-bucket histogram over non-negative observations.

    Bucket ``i`` holds values whose ``math.frexp`` exponent is
    ``i - EXP_OFFSET``, i.e. the half-open octave
    ``[2**(i - EXP_OFFSET - 1), 2**(i - EXP_OFFSET))``; bucket 0 holds
    zero and anything below ``2**-EXP_OFFSET``. With the default 64
    buckets the resolvable range spans ~6e-8 .. 5.5e11 — microsecond
    latencies, second-scale latencies, and bf16 error floors all land in
    interior buckets. ``percentile`` walks the cumulative counts and
    interpolates linearly within the target bucket, clamped to the exact
    observed ``[min, max]``.
    """

    __slots__ = ("counts", "count", "total", "min", "max")

    # Exponent floor: bucket index = frexp exponent + EXP_OFFSET.
    EXP_OFFSET = 24

    def __init__(self, max_buckets: int = 64) -> None:
        self.counts = [0] * max_buckets
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bucket(self, v: float) -> int:
        if v <= 0.0:
            return 0
        return min(
            len(self.counts) - 1, max(0, math.frexp(v)[1] + self.EXP_OFFSET)
        )

    def _bucket_range(self, i: int) -> tuple[float, float]:
        lo = 0.0 if i == 0 else 2.0 ** (i - self.EXP_OFFSET - 1)
        return lo, 2.0 ** (i - self.EXP_OFFSET)

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (``q`` in [0, 100])."""
        if not self.count:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= target:
                lo, hi = self._bucket_range(i)
                frac = (target - seen) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max  # pragma: no cover - target <= count by construction

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (in place; returns self).

        Both histograms must share the bucketing (same bucket count) —
        the percentile estimate of the merge is then exactly the estimate
        a single histogram observing both streams would give.
        """
        if len(self.counts) != len(other.counts):
            raise ValueError(
                f"bucket mismatch: {len(self.counts)} vs {len(other.counts)}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for bound, pick in (("min", min), ("max", max)):
            theirs = getattr(other, bound)
            if theirs is not None:
                ours = getattr(self, bound)
                setattr(
                    self, bound,
                    theirs if ours is None else pick(ours, theirs),
                )
        return self

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


def _key(name: str, labels: dict) -> str:
    """Render a metric identity: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Name (+ labels) -> metric registry with create-on-first-use.

    One registry instruments one server; ``snapshot()`` is the stable
    export format (plain dict) the Zipf bench embeds per record::

        {"counters": {name: int}, "gauges": {name: float},
         "histograms": {name: {count, mean, min, max, p50, p95, p99}}}

    Labeled metrics appear under their rendered ``name{k=v}`` key.
    ``merge`` folds another registry in (counters add, gauges last-write-
    wins, histograms bucket-merge) for cross-registry aggregation.
    """

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = _key(name, labels)
        if key not in self._counters:
            self._counters[key] = Counter()
        return self._counters[key]

    def histogram(self, name: str, **labels) -> Histogram:
        key = _key(name, labels)
        if key not in self._histograms:
            self._histograms[key] = Histogram()
        return self._histograms[key]

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges[_key(name, labels)] = float(value)

    def gauge(self, name: str, default: float = 0.0, **labels) -> float:
        return self._gauges.get(_key(name, labels), default)

    def count(self, name: str, **labels) -> int:
        """Current value of a counter (0 if never incremented)."""
        c = self._counters.get(_key(name, labels))
        return c.value if c is not None else 0

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other``'s metrics into self (in place; returns self)."""
        for k, c in other._counters.items():
            self.counter(k).inc(c.value)
        self._gauges.update(other._gauges)
        for k, h in other._histograms.items():
            self.histogram(k).merge(h)
        return self

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
        }
