"""Snapshot-decoupled serving: train on the live state, read a frozen replica.

Counterpart of ``repro/serve/snapshot.py`` (without the replay log and the
evict / readmit lifecycle, which arrive with the replay engine, ROADMAP §1
item 8). The queue keeps advancing its live state; a
:class:`SnapshotServer` publishes a read replica at flush boundaries, and
reads (the fused predict kernel) only ever see a published replica:

* **no torn reads** — a replica is one state reference captured at a flush
  boundary. The bank tier never updates its state in place (every kernel
  writes theta' and, for KRLS, P' into fresh tensors), so a published
  replica cannot change under its readers, and CPython reference
  assignment is atomic;
* **bounded staleness** — a replica is published at the first flush
  boundary where ``publish_every`` ticks have accumulated;
* **deferred write-flush** — flushes may wait for the age / size
  watermarks without blocking or corrupting reads.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.bank import bank_predict_block
from repro_torch.features.base import FeatureLike
from repro_torch.serve.queue import MicroBatchQueue

__all__ = ["StateSnapshot", "SnapshotServer"]


class _Row(NamedTuple):
    """A one-tenant read view: the predict path reads theta alone, so the
    same row serves a KLMS and a KRLS replica."""

    theta: torch.Tensor


class StateSnapshot(NamedTuple):
    """A published read replica: the bank state at a flush boundary, its
    publish counter (0 = initial state) and the cumulative ticks folded
    into it."""

    state: Any
    version: int
    tick: int


class SnapshotServer:
    """Double-buffered serving front end over a :class:`MicroBatchQueue`.

    Args:
      queue: the micro-batch queue owning the live (train) state.
      rff: the bank's shared feature map (on the state's device).
      publish_every: publish at the first flush boundary where this many
        update-ticks have accumulated since the last publish.
      mode / precision: read-path knobs for the fused predict kernel.
      age_watermark: seconds — flush when the oldest queued observation has
        waited this long (checked on ``submit`` / ``maybe_flush``).
      size_watermark: flush when any tenant's backlog reaches this depth.
      clock: injectable monotonic clock.
    """

    def __init__(self, queue: MicroBatchQueue, rff: FeatureLike,
                 publish_every: int = 1, *, mode: str = "auto",
                 precision: Optional[str] = None,
                 age_watermark: Optional[float] = None,
                 size_watermark: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        self.queue = queue
        self.rff = rff
        self.publish_every = publish_every
        self.mode = mode
        self.precision = precision
        self.age_watermark = age_watermark
        self.size_watermark = size_watermark
        self._clock = clock
        self._arrival_times = [deque() for _ in range(queue.num_tenants)]
        self._snapshot = StateSnapshot(state=queue.state, version=0, tick=0)

    # -- read path ---------------------------------------------------------

    @property
    def snapshot(self) -> StateSnapshot:
        """The current read replica (grab once per request)."""
        return self._snapshot

    @property
    def staleness(self) -> int:
        """Update-ticks the read replica lags the live state."""
        return self.queue.ticks_served - self._snapshot.tick

    def _queries(self, xs) -> torch.Tensor:
        return torch.as_tensor(xs, dtype=self.queue.state.theta.dtype,
                               device=self.queue.device).contiguous()

    def predict(self, tenant: int, xs) -> torch.Tensor:
        """Serve queries for one tenant from the frozen replica: ``xs (d,)``
        gives a scalar, ``(Q, d)`` gives ``(Q,)``."""
        snap = self._snapshot
        xq = self._queries(xs)
        single = xq.ndim == 1
        if single:
            xq = xq[None]
        row = _Row(theta=snap.state.theta[tenant][None])
        pred = bank_predict_block(row, xq[None], self.rff, mode=self.mode,
                                  precision=self.precision)[0]
        return pred[0] if single else pred

    def predict_block(self, xq) -> torch.Tensor:
        """Serve a ``(B, Q, d)`` query block for the whole bank in one
        launch from the frozen replica -> ``(B, Q)``."""
        snap = self._snapshot
        return bank_predict_block(snap.state, self._queries(xq), self.rff,
                                  mode=self.mode, precision=self.precision)

    # -- write path --------------------------------------------------------

    def submit(self, tenant: int, x, y) -> None:
        """Enqueue one observation; flush if a watermark trips."""
        # Tag the arrival with its backlog position: a flush consumes
        # exactly the timestamps of the positions it served.
        pos = len(self.queue._pending[tenant])
        self.queue.submit(tenant, x, y)
        self._arrival_times[tenant].append((pos, self._clock()))
        self.maybe_flush()

    def _consume_arrival_times(self, tenant: int, served: int) -> None:
        times = self._arrival_times[tenant]
        while times and times[0][0] < served:
            times.popleft()
        self._arrival_times[tenant] = deque(
            (pos - served, t) for pos, t in times
        )

    def maybe_flush(self) -> dict:
        """Flush when the age or size watermark trips."""
        backlog = self.queue.backlog()
        if not any(backlog):
            return {}
        if (self.size_watermark is not None
                and max(backlog) >= self.size_watermark):
            return self.flush()
        if self.age_watermark is not None:
            oldest = min(
                (t[0][1] for t in self._arrival_times if t), default=None
            )
            if oldest is not None and (
                self._clock() - oldest >= self.age_watermark
            ):
                return self.flush()
        return {}

    def flush(self) -> dict:
        """One chunked train launch on the live state; publish when due
        (due-ness comes from :attr:`staleness`, so ticks applied through
        ``queue.flush()`` directly still count)."""
        res = self.queue.flush()
        for tenant, served in res.items():
            self._consume_arrival_times(tenant, len(served))
        if self.staleness >= self.publish_every:
            self.publish()
        return res

    def drain(self) -> dict:
        """Flush until every backlog is empty; merge per-tenant results."""
        merged: dict = {}
        while any(self.queue.backlog()):
            for tenant, served in self.flush().items():
                merged.setdefault(tenant, []).extend(served)
        return merged

    def publish(self) -> StateSnapshot:
        """Swap the read replica to the live state (one reference
        assignment; the live state is never mutated in place)."""
        self._snapshot = StateSnapshot(
            state=self.queue.state,
            version=self._snapshot.version + 1,
            tick=self.queue.ticks_served,
        )
        return self._snapshot
