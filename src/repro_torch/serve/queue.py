"""Micro-batching serve queue: ragged tenant arrivals -> masked (B, T) chunks.

Counterpart of ``repro/serve/queue.py``. Arrivals are enqueued per tenant
at any rate; each ``flush()`` coalesces up to T pending observations per
tenant into ONE chunk launch: a ``(B, T, d)`` batch with a per-(tenant,
tick) validity mask covering idle tenants (empty rows) and short backlogs
(partial rows). A tenant that missed k flushes needs no catch-up: its next
chunk replays its queued samples in arrival order, and masked ticks are
no-ops.

Host-side and synchronous (submit / flush). The batch is assembled in
numpy, copied to the state's device in one transfer, and the chunk step
runs there (the CUDA chunk kernel on the card). An attached probe
(:meth:`MicroBatchQueue.attach_probe`) runs right after the chunk step;
each flush opens a ``queue.flush`` span and counts
``dispatch.launches{site=queue.flush}`` in ``obs.telemetry``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.bank import set_tenant_row
from repro_torch.obs import telemetry as _telemetry
from repro_torch.obs import trace as _trace

__all__ = ["MicroBatchQueue"]


class MicroBatchQueue:
    """Coalesce ragged per-tenant arrivals into masked ``(B, T)`` chunks.

    Args:
      chunk_step: ``(state, xs, ys, mask) -> (state, StepOut)`` on tensors.
      state: initial bank state (owned and advanced by the queue).
      input_dim: ``d`` of the feature space.
      chunk: T — the time-block cap of every flush.
      adaptive: size each flush's T to the deepest backlog, rounded up to
        a power of two and capped at ``chunk``, instead of always ``chunk``.
      stale_after: watchdog age bound in ``clock`` units; with it set,
        :meth:`has_stale` reports an arrival pending that long and
        :meth:`maybe_flush` force-flushes it. None disables the watchdog.
      clock: injectable time source for the watchdog.

    ``flush`` returns ``{tenant: [(prediction, prior_error), ...]}`` for
    what it consumed; ``drain`` flushes until every backlog is empty.
    """

    def __init__(self, chunk_step: Callable, state, input_dim: int,
                 chunk: int = 16, adaptive: bool = False,
                 stale_after: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._chunk_step = chunk_step
        self.state = state
        self.input_dim = input_dim
        self.chunk = chunk
        self.adaptive = adaptive
        self.stale_after = stale_after
        self._clock = clock
        lead = state[0]  # any family: the first leaf has the bank axis
        self.num_tenants = int(lead.shape[0])
        self.device = lead.device
        self._dtype = np.dtype(str(lead.dtype).removeprefix("torch."))
        self._pending = [deque() for _ in range(self.num_tenants)]
        # When each slot's oldest pending arrival was enqueued (None =
        # empty backlog); kept across partial flushes.
        self._first_pending_at: list[Optional[float]] = (
            [None] * self.num_tenants
        )
        self.arrivals = [0] * self.num_tenants
        self.ticks_served = 0
        self.flushes = 0
        self.stale_flushes = 0
        self._probe: Optional[Callable] = None
        self.last_probe: Optional[dict] = None

    def attach_probe(self, probe_fn: Optional[Callable]) -> None:
        """Run ``probe_fn(state) -> {name: 0-d tensor}`` after every chunk
        step (obs/probes.py ``stats_tap``). The latest readout lands in
        ``last_probe`` as tensors on the state's device; the serve facade
        copies it to the host at flush boundaries. ``None`` detaches it."""
        self._probe = probe_fn
        if probe_fn is None:
            self.last_probe = None

    def check_arrival(self, tenant: int, x) -> np.ndarray:
        """``x`` as this queue's dtype; raises for a tenant outside the bank
        or an ``x`` of the wrong shape."""
        if not 0 <= tenant < self.num_tenants:
            raise IndexError(f"tenant {tenant} outside [0, {self.num_tenants})")
        return self.check_x(x)

    def check_x(self, x) -> np.ndarray:
        """``x`` as this queue's dtype; raises for a wrong shape."""
        x = np.asarray(x, self._dtype)
        if x.shape != (self.input_dim,):
            raise ValueError(f"x has shape {x.shape}, expected ({self.input_dim},)")
        return x

    def submit(self, tenant: int, x, y) -> None:
        """Enqueue one ``(x, y)`` observation for ``tenant``."""
        self._enqueue(tenant, self.check_arrival(tenant, x), y)

    def _enqueue(self, tenant: int, x: np.ndarray, y) -> None:
        """Enqueue an ``x`` that :meth:`check_arrival` already returned."""
        self.arrivals[tenant] += 1
        if not self._pending[tenant] and self.stale_after is not None:
            self._first_pending_at[tenant] = self._clock()
        self._pending[tenant].append((x, self._dtype.type(y)))

    def backlog(self) -> list[int]:
        """Pending observation count per tenant."""
        return [len(q) for q in self._pending]

    def drop_pending(self, tenant: int) -> int:
        """Discard ``tenant``'s queued observations (the eviction hook).
        Returns the number dropped; other backlogs, the state and the
        counters are untouched (a dropped observation was never trained)."""
        dropped = len(self._pending[tenant])
        self._pending[tenant].clear()
        self._first_pending_at[tenant] = None
        return dropped

    def move_slot(self, src: int, dst: int) -> None:
        """Move one slot's pending backlog and arrival counter to another
        slot (bank compaction; the state row moves through
        ``tenant_row`` / ``set_tenant_row``). ``src`` is left empty."""
        if src == dst:
            return
        self._pending[dst] = self._pending[src]
        self._pending[src] = deque()
        self._first_pending_at[dst] = self._first_pending_at[src]
        self._first_pending_at[src] = None
        self.arrivals[dst] = self.arrivals[src]
        self.arrivals[src] = 0

    def adopt(self, state) -> None:
        """Adopt a resized bank state (``core.bank.resize_bank``): B follows
        the state and the per-slot buffers grow or shrink with it. Slots cut
        off must have empty backlogs: compact first."""
        new_b = int(state[0].shape[0])
        if any(len(q) for q in self._pending[new_b:]):
            raise RuntimeError(
                "resize would drop pending observations; compact or drain"
            )
        self.state = state
        if new_b >= self.num_tenants:
            grow = new_b - self.num_tenants
            self._pending.extend(deque() for _ in range(grow))
            self._first_pending_at.extend([None] * grow)
            self.arrivals.extend([0] * grow)
        else:
            self._pending = self._pending[:new_b]
            self._first_pending_at = self._first_pending_at[:new_b]
            self.arrivals = self.arrivals[:new_b]
        self.num_tenants = new_b

    def replace_tenant(self, tenant: int, row) -> None:
        """Overwrite one tenant's slot of the live state with a
        single-tenant ``row`` (out of place: a published replica keeps the
        old state)."""
        self.state = set_tenant_row(self.state, tenant, row)

    def _flush_chunk(self) -> int:
        """T for the next flush: ``chunk``, or in adaptive mode the deepest
        backlog rounded up to a power of two (at most log2(chunk)+1
        distinct shapes)."""
        if not self.adaptive:
            return self.chunk
        depth = max(1, max(self.backlog(), default=1))
        return min(self.chunk, 1 << (depth - 1).bit_length())

    def has_stale(self) -> bool:
        """True when some arrival has been pending past ``stale_after``."""
        if self.stale_after is None:
            return False
        now = self._clock()
        return any(
            t0 is not None and now - t0 >= self.stale_after
            for t0 in self._first_pending_at
        )

    def maybe_flush(self) -> dict:
        """Watchdog flush: launch only if some backlog has gone stale."""
        if not self.has_stale():
            return {}
        self.stale_flushes += 1
        _telemetry.registry().counter("queue.stale_flush").inc()
        return self.flush()

    def flush(self) -> dict:
        """One chunked launch over up to T queued ticks per tenant."""
        bsz, tlen, d = self.num_tenants, self._flush_chunk(), self.input_dim
        if not any(self._pending):
            _trace.instant("queue.flush.skip", tenants=bsz)
            return {}
        with _trace.span("queue.flush", tenants=bsz, chunk=tlen,
                         adaptive=self.adaptive) as sp:
            xs = np.zeros((bsz, tlen, d), self._dtype)
            ys = np.zeros((bsz, tlen), self._dtype)
            mask = np.zeros((bsz, tlen), self._dtype)
            counts = []
            for b, q in enumerate(self._pending):
                take = min(len(q), tlen)
                for t in range(take):
                    xs[b, t], ys[b, t] = q.popleft()
                mask[b, :take] = 1.0
                counts.append(take)
                if not q:
                    self._first_pending_at[b] = None
            dev = self.device
            self.state, out = self._chunk_step(
                self.state,
                torch.from_numpy(xs).to(dev),
                torch.from_numpy(ys).to(dev),
                torch.from_numpy(mask).to(dev),
            )
            if self._probe is not None:
                self.last_probe = self._probe(self.state)
            preds = out.prediction.cpu().numpy()
            errs = out.error.cpu().numpy()
            self.flushes += 1
            served = sum(counts)
            self.ticks_served += served
            _telemetry.registry().counter(
                "dispatch.launches", site="queue.flush").inc()
            if sp is not None:
                sp.attrs["ticks"] = served
                sp.attrs["active"] = sum(1 for c in counts if c)
                sp.attrs["residual_backlog"] = sum(self.backlog())
            return {
                b: [(float(preds[b, t]), float(errs[b, t])) for t in range(c)]
                for b, c in enumerate(counts)
                if c
            }

    def drain(self) -> dict:
        """Flush until all backlogs are empty; merge per-tenant results."""
        merged: dict = {}
        while any(self._pending):
            for b, res in self.flush().items():
                merged.setdefault(b, []).extend(res)
        return merged
