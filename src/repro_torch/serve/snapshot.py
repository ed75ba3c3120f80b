"""Snapshot-decoupled serving: train on the live state, read a frozen replica.

Counterpart of ``repro/serve/snapshot.py``. The queue keeps advancing its
live state; a
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

Tenant lifecycle: with a ``log_capacity``, every arrival is also appended
to a per-tenant :class:`ReplayLog` ring, so ``evict(tenant)`` releases the
slot as one row write (``core.bank.evict_tenant``) and ``readmit(tenant)``
rebuilds it by replaying the log (``core.bank.rebuild_tenant`` over
``core/scan.py``). While evicted, a tenant's arrivals are logged but not
trained; readmission folds them in. The policy tier (``serve/api.py``)
keeps its own log keyed by tenant id and drives the slots through
``release_slot``, ``move_slot``, ``adopt_resized`` and ``reset``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bank import (
    bank_predict_block,
    evict_tenant,
    rebuild_tenant,
)
from repro_torch.features.base import FeatureLike, map_to
from repro_torch.obs import trace as _trace
from repro_torch.serve.queue import MicroBatchQueue

__all__ = [
    "ReplayLog",
    "StateSnapshot",
    "SnapshotServer",
    "predict_row",
    "klms_snapshot_server",
    "krls_snapshot_server",
]


class ReplayLog:
    """Per-tenant ring buffer of raw ``(x, y)`` arrivals for slot rebuilds.

    Host-side numpy, like the queue's backlogs. A tenant whose history
    outgrows ``capacity`` loses its oldest ticks, and a rebuild from the
    log then gives the *windowed* state (fresh init + the last
    ``capacity`` ticks); :meth:`complete` says which contract holds. Keys
    are ints created on first append: slot indices on the snapshot tier,
    unbounded tenant ids on the policy tier. ``num_tenants`` is accepted
    for ``repro``'s signature and sizes nothing.
    """

    def __init__(self, num_tenants: int = 0, capacity: int = 256,
                 dtype=np.float32):
        del num_tenants
        if capacity < 1:
            raise ValueError("log capacity must be >= 1")
        self.capacity = capacity
        self._dtype = np.dtype(dtype)
        self._buf: dict[int, deque] = {}
        self._appended: dict[int, int] = {}

    def append(self, tenant: int, x, y) -> None:
        """Record one arrival (the oldest entry goes when the ring is
        full)."""
        buf = self._buf.get(tenant)
        if buf is None:
            buf = self._buf[tenant] = deque(maxlen=self.capacity)
        self._appended[tenant] = self._appended.get(tenant, 0) + 1
        buf.append((np.asarray(x, self._dtype), self._dtype.type(y)))

    def tenants(self) -> list[int]:
        """Keys with any recorded history."""
        return list(self._buf)

    def size(self, tenant: int) -> int:
        """Entries held for ``tenant`` (at most ``capacity``)."""
        buf = self._buf.get(tenant)
        return len(buf) if buf is not None else 0

    def dropped(self, tenant: int) -> int:
        """Arrivals lost to ring overflow since the last :meth:`clear`."""
        return self._appended.get(tenant, 0) - self.size(tenant)

    def complete(self, tenant: int) -> bool:
        """True iff the log still holds the tenant's whole history, so a
        rebuild from it matches the never-evicted state."""
        return self.dropped(tenant) == 0

    def arrays(self, tenant: int) -> tuple[np.ndarray, np.ndarray]:
        """The log as ``xs (n, d)``, ``ys (n,)`` in arrival order (an empty
        log gives ``(0, 0)`` and ``(0,)``)."""
        buf = self._buf.get(tenant)
        if not buf:
            return (np.zeros((0, 0), self._dtype),
                    np.zeros((0,), self._dtype))
        xs = np.stack([x for x, _ in buf])
        ys = np.asarray([y for _, y in buf], self._dtype)
        return xs, ys

    def move(self, src: int, dst: int) -> None:
        """Re-key one history (bank compaction): ``dst`` takes over
        ``src``'s buffer and overflow counter; with none at ``src``,
        ``dst`` is cleared."""
        self.clear(dst)
        buf = self._buf.pop(src, None)
        if buf is not None:
            self._buf[dst] = buf
            self._appended[dst] = self._appended.pop(src)

    def clear(self, tenant: Optional[int] = None) -> None:
        """Forget one tenant's history, overflow counter included (so it
        reads :meth:`complete` again), or every tenant's when None."""
        if tenant is None:
            self._buf.clear()
            self._appended.clear()
        else:
            self._buf.pop(tenant, None)
            self._appended.pop(tenant, None)


class _Row(NamedTuple):
    """A one-tenant read view: the predict path reads theta alone, so the
    same row serves a KLMS and a KRLS replica."""

    theta: torch.Tensor


def predict_row(theta, xq, rff, *, mode: str = "auto",
                precision: Optional[str] = None) -> torch.Tensor:
    """Fused predict from one bare ``(D,)`` theta row: ``xq (Q, d)`` ->
    ``(Q,)``, one read launch at B = 1. The quarantine read path
    (serve/recovery.py) serves a tenant's captured last-healthy row through
    it, outside any bank."""
    theta = torch.as_tensor(theta)
    xq = torch.as_tensor(xq, dtype=theta.dtype, device=theta.device)
    return bank_predict_block(_Row(theta=theta[None]),
                              xq.contiguous()[None], rff, mode=mode,
                              precision=precision)[0]


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
      log_capacity: entries per tenant in the :class:`ReplayLog` ring. None
        disables logging: ``evict`` still parks a fresh row, and
        ``readmit`` then restarts the tenant cold.
      evict_fn: ``(state, tenant) -> state`` releasing one slot;
        ``core.bank.evict_tenant`` by default.
      rebuild_fn: ``(state, tenant, xs, ys) -> state`` replaying a log into
        one slot (``make_server`` wires ``core.bank.rebuild_tenant`` with
        the family's hyperparameters and replay mode).
    """

    def __init__(self, queue: MicroBatchQueue, rff: FeatureLike,
                 publish_every: int = 1, *, mode: str = "auto",
                 precision: Optional[str] = None,
                 age_watermark: Optional[float] = None,
                 size_watermark: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 log_capacity: Optional[int] = None,
                 evict_fn: Optional[Callable] = None,
                 rebuild_fn: Optional[Callable] = None):
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
        self.log = (ReplayLog(capacity=log_capacity, dtype=queue._dtype)
                    if log_capacity is not None else None)
        self._evict_fn = evict_fn if evict_fn is not None else evict_tenant
        self._rebuild_fn = rebuild_fn
        self._evicted: set[int] = set()

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
        return torch.as_tensor(xs, dtype=self.queue.state[0].dtype,
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
        """Enqueue one observation; flush if a watermark trips.

        Every arrival is also appended to the replay log (when there is
        one). An evicted tenant's arrivals stop there: logged, never
        queued, until :meth:`readmit` folds the whole log back in.
        """
        x = self.queue.check_arrival(tenant, x)
        if self.log is not None:
            self.log.append(tenant, x, y)
        if tenant in self._evicted:
            return
        # Tag the arrival with its backlog position: a flush consumes
        # exactly the timestamps of the positions it served.
        pos = len(self.queue._pending[tenant])
        self.queue._enqueue(tenant, x, y)
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

    # -- tenant lifecycle --------------------------------------------------

    @property
    def evicted(self) -> frozenset[int]:
        """Tenants whose slots are released."""
        return frozenset(self._evicted)

    def evict(self, tenant: int) -> int:
        """Release one slot: drop the tenant's pending observations, park a
        fresh row in the slot and publish, so readers stop seeing the old
        weights at once. The replay log is kept: it is what
        :meth:`readmit` rebuilds from. Returns the number of pending
        observations dropped (logged on submit, so still replayed)."""
        dropped = self.queue.drop_pending(tenant)
        self._arrival_times[tenant].clear()
        self.queue.state = self._evict_fn(self.queue.state, tenant)
        self._evicted.add(tenant)
        self.publish()
        return dropped

    def readmit(self, tenant: int) -> int:
        """Re-admit an evicted tenant by replaying its log into the slot
        through ``rebuild_fn``, then publish. With no log, or an empty one,
        the tenant restarts cold on the parked fresh row. Returns the ticks
        replayed; when the ring overflowed (``log.complete(tenant)`` is
        False) the rebuilt state is the windowed one."""
        if tenant not in self._evicted:
            raise ValueError(f"tenant {tenant} is not evicted")
        replayed = 0
        if self.log is not None and self.log.size(tenant):
            if self._rebuild_fn is None:
                raise ValueError(
                    "readmit with a non-empty log needs a rebuild_fn "
                    "(make_server wires one)"
                )
            xs, ys = self.log.arrays(tenant)
            with _trace.span("snapshot.rebuild", tenant=tenant,
                             ticks=len(ys),
                             complete=self.log.complete(tenant)):
                self.queue.state = self._rebuild_fn(self.queue.state, tenant,
                                                    xs, ys)
            replayed = len(ys)
        self._evicted.discard(tenant)
        self.publish()
        return replayed

    def reset_tenant(self, tenant: int) -> int:
        """Reset one tenant to a fresh slot: drop its pending observations,
        its arrival times and its log history (overflow flag included),
        park a fresh row, leave the evicted set and publish. Returns the
        dropped pending count."""
        dropped = self.queue.drop_pending(tenant)
        self._arrival_times[tenant].clear()
        if self.log is not None:
            self.log.clear(tenant)
        self.queue.state = self._evict_fn(self.queue.state, tenant)
        self._evicted.discard(tenant)
        self.publish()
        return dropped

    def release_slot(self, slot: int) -> int:
        """Release one slot without entering the evicted set (the policy
        tier's eviction): drop its pending observations and arrival times,
        park a fresh row and publish. Later submits to the slot train (the
        policy hands it to another tenant at once, whose history lives in
        the policy tier's log). Returns the dropped pending count."""
        dropped = self.queue.drop_pending(slot)
        self._arrival_times[slot].clear()
        self.queue.state = self._evict_fn(self.queue.state, slot)
        self._evicted.discard(slot)
        self.publish()
        return dropped

    def move_slot(self, src: int, dst: int) -> None:
        """Move the slot bookkeeping of ``src`` to ``dst`` (bank compaction;
        the caller moves the state row): pending backlog, arrival counter
        and times, evicted membership and slot-keyed log. ``src`` is left
        empty."""
        self.queue.move_slot(src, dst)
        self._arrival_times[dst] = self._arrival_times[src]
        self._arrival_times[src] = deque()
        if src in self._evicted:
            self._evicted.discard(src)
            self._evicted.add(dst)
        else:
            self._evicted.discard(dst)
        if self.log is not None:
            self.log.move(src, dst)

    def adopt_resized(self, state) -> None:
        """Adopt a grown or shrunk bank state (the policy tier's resize):
        resize the queue's per-slot buffers and the arrival times, drop the
        bookkeeping of truncated slots (which must be empty: compact
        first) and publish."""
        old = self.queue.num_tenants
        self.queue.adopt(state)
        new = self.queue.num_tenants
        if new >= old:
            self._arrival_times.extend(deque() for _ in range(new - old))
        else:
            self._arrival_times = self._arrival_times[:new]
            self._evicted = {s for s in self._evicted if s < new}
            if self.log is not None:
                for t in self.log.tenants():
                    if t >= new:
                        self.log.clear(t)
        self.publish()

    def reset(self, state) -> None:
        """Restart both buffers on a fresh bank state: the live state and
        the replica drop to version 0, and the arrival counters, replay
        logs (overflow flags included) and evicted set are wiped. Raises
        while observations are pending: drain first."""
        if any(self.queue.backlog()):
            raise RuntimeError("reset with pending observations; drain first")
        self.queue.state = state
        self.queue.ticks_served = 0
        self.queue.arrivals = [0] * self.queue.num_tenants
        self._arrival_times = [deque() for _ in range(self.queue.num_tenants)]
        self._snapshot = StateSnapshot(state=state, version=0, tick=0)
        if self.log is not None:
            self.log.clear()
        self._evicted.clear()

    def publish(self) -> StateSnapshot:
        """Swap the read replica to the live state (one reference
        assignment; the live state is never mutated in place)."""
        self._snapshot = StateSnapshot(
            state=self.queue.state,
            version=self._snapshot.version + 1,
            tick=self.queue.ticks_served,
        )
        _trace.instant("snapshot.publish", version=self._snapshot.version,
                       tick=self._snapshot.tick)
        return self._snapshot


def klms_snapshot_server(rff: FeatureLike, num_tenants: int,
                         mu: Union[float, torch.Tensor] = 0.5,
                         chunk: int = 16, publish_every: int = 1,
                         mode: str = "auto",
                         precision: Optional[str] = None,
                         adaptive: bool = False, rebuild_mode: str = "scan",
                         device="cuda", **kw) -> SnapshotServer:
    """Deprecated: use ``repro_torch.serve.make_server(learner="klms",
    ...)``.

    Thin shim preserving the historical contract (returns the bare
    :class:`SnapshotServer`; per-tenant ``(B,)`` ``mu`` honored); the map
    and the state live on ``device``, the card by default."""
    from repro_torch.serve import api

    api._deprecated("klms_snapshot_server",
                    'make_server(learner="klms", ...)')
    fm = map_to(rff, resolve_device(device))
    queue = api.make_queue("klms", fm, num_tenants, chunk=chunk, mode=mode,
                           adaptive=adaptive, device=device, mu=mu)
    kw.setdefault(
        "rebuild_fn",
        lambda state, tenant, xs, ys: rebuild_tenant(
            state, tenant, fm, xs, ys, mu=mu, mode=rebuild_mode,
            kernel_mode=mode),
    )
    return SnapshotServer(queue, fm, publish_every, mode=mode,
                          precision=precision, **kw)


def krls_snapshot_server(rff: FeatureLike, num_tenants: int,
                         lam: Union[float, torch.Tensor] = 1e-4,
                         beta: Union[float, torch.Tensor] = 0.9995,
                         chunk: int = 16, publish_every: int = 1,
                         mode: str = "auto",
                         precision: Optional[str] = None,
                         adaptive: bool = False, rebuild_mode: str = "scan",
                         device="cuda", **kw) -> SnapshotServer:
    """Deprecated: use ``repro_torch.serve.make_server(learner="krls",
    ...)``.

    Thin shim preserving the historical contract (returns the bare
    :class:`SnapshotServer`; per-tenant ``(B,)`` ``lam``/``beta``
    honored); the map and the state live on ``device``, the card by
    default."""
    from repro_torch.serve import api

    api._deprecated("krls_snapshot_server",
                    'make_server(learner="krls", ...)')
    fm = map_to(rff, resolve_device(device))
    queue = api.make_queue("krls", fm, num_tenants, chunk=chunk, mode=mode,
                           adaptive=adaptive, device=device, lam=lam,
                           beta=beta)
    kw.setdefault(
        "evict_fn",
        lambda state, tenant: evict_tenant(state, tenant, lam=lam),
    )
    kw.setdefault(
        "rebuild_fn",
        lambda state, tenant, xs, ys: rebuild_tenant(
            state, tenant, fm, xs, ys, lam=lam, beta=beta, mode=rebuild_mode,
            kernel_mode=mode),
    )
    return SnapshotServer(queue, fm, publish_every, mode=mode,
                          precision=precision, **kw)
