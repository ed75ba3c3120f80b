"""The lockstep driver: the bank's whole-block calls, below the serving
facade.

One client keeps ``inflight`` rounds outstanding. Round g: the reset of
the slots whose sessions start at g (one ``reset_slots`` call every
``reset_every`` rounds), one write block through the chunk step on the
state the last round left, then, where the mix has queries, one read
block on the state this write returned. Each result (the write's prior
predictions and errors, the read's predictions) is copied into pinned host
memory without blocking and an event is recorded after the copy; the
client collects the oldest round by its events, so collecting one request
never waits for work queued after it. A request's latency runs from the
host clock before its call to the host clock once its event has
completed. Inputs come from the pool made in set-up: nothing crosses from
the host in the window.

The system is :class:`portbench.system.ProgramSystem` (the program's
lockstep tier) unless the run names another with the same calls."""
from __future__ import annotations

import collections
import time

import torch

from portbench.bank import add_write_costs
from portbench.harness import Event, bound_s
from portbench.system import ProgramSystem

__all__ = ["FIELDS", "Client"]

FIELDS = ()  # the family's fields alone


class Client:
    """The client: issues rounds and collects them in order."""

    def __init__(self, cell, system, inputs, seed, device):
        del seed  # every input is the pool's
        w, b, pool = inputs.w, inputs.b, inputs.pool
        system = (system or ProgramSystem)(cell, w, b)
        cfg, traffic = cell.cfg, cell.traffic
        self.cell = cell
        self.system, self.pool, self.traffic = system, pool, traffic
        self.cuda = torch.device(device).type == "cuda"
        bank, chunk, q = cfg["bank"], cfg["chunk"], traffic.queries
        sched = pool.schedule
        self.resets = [sched.slots(j).to(device) for j in range(sched.groups)]
        # Results of the last stream_rounds rounds stay for the comparison.
        self.ring = sched.stream_rounds + traffic.inflight + 1
        pin = dict(pin_memory=self.cuda)
        self.wbuf = torch.empty(self.ring, 2, bank, chunk, **pin)
        self.rbuf = torch.empty(self.ring, bank, q, **pin) if q else None
        self.wev = [Event(self.cuda) for _ in range(self.ring)]
        self.rev = [Event(self.cuda) for _ in range(self.ring)]
        self.state = system.init()
        self.pending = collections.deque()
        self.g = 0
        self.run = None  # set for the measured window

    def issue(self):
        g, pool, sysm = self.g, self.pool, self.system
        slot, k = g % self.ring, g % pool.blocks
        grp = pool.schedule.reset_group(g)
        if grp is not None:
            with torch.profiler.record_function("portbench.reset"):
                self.state = sysm.reset(self.state, self.resets[grp])
        t_w = time.perf_counter()
        with torch.profiler.record_function("portbench.write"):
            self.state, pred, err = sysm.write(
                self.state, pool.xs[k], pool.ys[k], pool.mask[k])
        t_wd = time.perf_counter()
        self.wbuf[slot, 0].copy_(pred, non_blocking=True)
        self.wbuf[slot, 1].copy_(err, non_blocking=True)
        self.wev[slot].record()
        t_r = t_rd = None
        if self.rbuf is not None:
            xq = pool.xq[g % pool.read_blocks]
            t_r = time.perf_counter()
            with torch.profiler.record_function("portbench.read"):
                out = sysm.read(self.state, xq)
            t_rd = time.perf_counter()
            self.rbuf[slot].copy_(out, non_blocking=True)
            self.rev[slot].record()
        self.pending.append((g, t_w, t_wd, t_r, t_rd))
        self.g += 1

    def collect(self):
        g, t_w, t_wd, t_r, t_rd = self.pending.popleft()
        slot = g % self.ring
        with torch.profiler.record_function("portbench.collect"):
            self.wev[slot].synchronize()
            done_w = time.perf_counter()
            if t_r is not None:
                self.rev[slot].synchronize()
                done_r = time.perf_counter()
        run = self.run
        if run is None:
            return
        k = g % self.pool.blocks
        run.writes += 1
        run.obs += self.pool.live[k]
        run.write_latency_s.append(done_w - t_w)
        run.write_dispatch_s.append(t_wd - t_w)
        if t_r is not None:
            run.reads += 1
            run.read_latency_s.append(done_r - t_r)
            run.read_dispatch_s.append(t_rd - t_r)

    def rounds(self, n: int):
        for _ in range(n):
            self.step()
        self.drain()

    def step(self):
        self.issue()
        if len(self.pending) >= self.traffic.inflight:
            self.collect()

    def drain(self):
        while self.pending:
            self.collect()

    def results(self, g: int):
        """Round g's ``(predictions, errors, reads, slots read)``: every
        slot reads a block, so the last is None."""
        slot = g % self.ring
        reads = self.rbuf[slot] if self.rbuf is not None else None
        return self.wbuf[slot, 0], self.wbuf[slot, 1], reads, None

    def leaves(self) -> dict:
        return self.system.leaves(self.state)

    def release(self):
        self.state = None

    def costs(self, run, first: int, last: int):
        """Operations and bounds of rounds ``first..last-1`` into ``run``: a
        read is one block of every slot's queries."""
        add_write_costs(run, self.cell, self.pool, first, last)
        if run.reads:
            cfg = self.cell.cfg
            rows = cfg["bank"] * self.traffic.queries
            ops, nbytes = self.cell.counts.read(cfg, rows)
            run.read_rows = rows * run.reads
            run.read_ops = ops * run.reads
            run.read_bound_s = bound_s(run, ops, nbytes) * run.reads
