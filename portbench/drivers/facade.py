"""The facade driver: one client calls the serving facade per request.

The program is ``repro_torch.serve.make_server(family, feature_map=fm,
bank=B, chunk=T, **hp)`` with every other knob at its default
(``publish_every=1``; no policy, replay log, WAL, probe or tracer): the
front door as the README builds it. One client with one round
outstanding; round g:

- ``reset_tenant(slot)`` for each slot whose session starts at g (the
  generator's schedule: B / G calls every ``reset_every`` rounds);
- ``submit(tenant, x, y)`` once for each live tick of pool block g mod P,
  the tenants interleaved in an order drawn from the seed and each
  tenant's ticks in time order; ``x`` is a host float32 row, ``y`` a host
  float. The mix's rates are clipped at one tick a tick, so a tenant
  submits at most T a round and the round's flush trains every one;
- one ``flush()``, which returns each observation's prior prediction and
  error on the host;
- ``reads_per_round`` calls ``predict(tenant, xq)`` of ``queries`` host
  rows each: tenants drawn without replacement, with weights ``1 /
  rank^zipf_alpha`` over a ranking of the slots drawn from the seed, once
  for each of the pool's ``pool_read_blocks`` read blocks (whose queries
  they read; round g reads block g mod P_r). Each prediction is copied
  into pinned host memory without blocking and an event is recorded after
  the copy; after each call the client looks at its pending events,
  oldest first, and at the round's end it waits for the rest.

A write's latency runs from the host clock before its ``submit`` to the
flush's return; a read's from its call to the host clock at which the
client saw its event complete. Every input crosses from the host, as a
facade client's does: set-up copies the rows off the pool.

The comparison gets each flush's answers put back at the live ticks of
the pool's block (:func:`scatter`), the queue's state and the slots each
round read."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.bank import add_write_costs
from portbench.harness import Event, bound_s
from portbench.reference.common import features
from portbench.system import feature_map

__all__ = ["FIELDS", "Client", "ControlServer", "ProgramServer", "scatter"]

FIELDS = ("reads_per_round",)
_MASK64 = (1 << 63) - 1


class ProgramServer:
    """The program's front door: the calls the client makes, on one
    ``make_server``."""

    def __init__(self, cell, w: torch.Tensor, b: torch.Tensor):
        from repro_torch.serve import make_server

        cfg = cell.cfg
        self.server = make_server(cfg["family"],
                                  feature_map=feature_map(cfg, w, b),
                                  bank=cfg["bank"], chunk=cfg["chunk"],
                                  device=w.device, **cell.family.hp(cfg))
        self._leaves = cell.family.leaves

    def submit(self, tenant: int, x, y):
        self.server.submit(tenant, x, y)

    def flush(self) -> dict:
        return self.server.flush()

    def predict(self, tenant: int, xq) -> torch.Tensor:
        return self.server.predict(tenant, xq)

    def reset_tenant(self, tenant: int):
        self.server.reset_tenant(tenant)

    def leaves(self) -> dict:
        return self._leaves(self.server.queue.state)


class ControlServer:
    """The family's reference behind the same calls, one step below the
    configurations' float32 (float32 with TF32 products): the control that
    the comparison has to refuse. Arrivals queue per tenant; a flush packs
    up to T of each into a masked ``(B, T)`` block."""

    def __init__(self, cell, w: torch.Tensor, b: torch.Tensor):
        cfg = cell.cfg
        self.ref = cell.reference.Bank(cfg, w, b, dtype=torch.float32,
                                       tf32=True)
        self.chunk, self.dim = cfg["chunk"], cfg["input_dim"]
        self.pending = [[] for _ in range(cfg["bank"])]

    def submit(self, tenant: int, x, y):
        self.pending[tenant].append((x, y))

    def flush(self) -> dict:
        bank, tlen = len(self.pending), self.chunk
        xs = np.zeros((bank, tlen, self.dim), np.float32)
        ys = np.zeros((bank, tlen), np.float32)
        mask = np.zeros((bank, tlen), np.float32)
        taken = {}
        for tenant, queue in enumerate(self.pending):
            n = min(len(queue), tlen)
            for t in range(n):
                xs[tenant, t], ys[tenant, t] = queue[t]
            mask[tenant, :n] = 1.0
            del queue[:n]
            if n:
                taken[tenant] = n
        dev = self.ref.theta.device
        pred, err = self.ref.write(*(torch.from_numpy(a).to(dev)
                                     for a in (xs, ys, mask)))
        pred, err = pred.cpu().tolist(), err.cpu().tolist()
        return {b: list(zip(pred[b][:n], err[b][:n]))
                for b, n in taken.items()}

    def predict(self, tenant: int, xq) -> torch.Tensor:
        ref = self.ref
        z = features(torch.as_tensor(xq, device=ref.theta.device), ref.w,
                     ref.b, ref.tf32)
        return torch.einsum("qk,k->q", z, ref.theta[tenant])

    def reset_tenant(self, tenant: int):
        self.ref.reset(torch.tensor([tenant], device=self.ref.theta.device))

    def leaves(self) -> dict:
        return self.ref.leaves()


def scatter(answers: dict, tenants, ticks, shape) -> tuple:
    """A flush's answers ``{tenant: [(prediction, error), ...]}`` put back
    at a block's live ticks (``tenants``, ``ticks``: in row-major order,
    so each tenant's in time order) as ``(predictions, errors)`` of
    ``shape`` (B, T), float64, zero where no tick is live. A tenant
    answered for more or fewer ticks than it has live reads NaN at every
    one of them, and so does the whole block where a tenant with none
    live is answered."""
    pred = torch.zeros(shape, dtype=torch.float64)
    err = torch.zeros(shape, dtype=torch.float64)
    if not len(tenants):
        return pred, err
    slots, counts = np.unique(tenants, return_counts=True)
    vals = []
    for slot, n in zip(slots.tolist(), counts.tolist()):
        got = answers.get(slot, ())
        vals.extend(got if len(got) == n else [(math.nan, math.nan)] * n)
    v = torch.tensor(vals, dtype=torch.float64)
    if set(answers) - set(slots.tolist()):
        v.fill_(math.nan)
    b, t = torch.as_tensor(tenants), torch.as_tensor(ticks)
    pred[b, t], err[b, t] = v[:, 0], v[:, 1]
    return pred, err


def _write_blocks(pool, gen) -> list:
    """Each write block's submits: ``(tenants, x rows, ys)`` in the submit
    order (host ints, a host float32 array, host floats) and the block's
    live ticks ``(tenants, ticks)`` in row-major order."""
    live = torch.nonzero(pool.mask > 0)  # (N, 3) rows (block, slot, tick)
    order = torch.empty(len(live), dtype=torch.long, device=live.device)
    lo = 0
    for n in pool.live:
        slots = live[lo:lo + n, 1]
        shuffled = slots[torch.randperm(n, generator=gen, device=live.device)]
        # The j-th submit of a slot in the shuffled sequence takes its j-th
        # live tick: row-major tick i is submitted at place[i].
        place = torch.argsort(shuffled, stable=True)
        order[lo + place] = torch.arange(lo, lo + n, device=live.device)
        lo += n
    sub = live[order]
    xs = pool.xs[sub[:, 0], sub[:, 1], sub[:, 2]].cpu().numpy()
    ys = pool.ys[sub[:, 0], sub[:, 1], sub[:, 2]].cpu().tolist()
    tenants = sub[:, 1].cpu().tolist()
    rows = live.cpu().numpy()
    out, lo = [], 0
    for n in pool.live:
        out.append((tenants[lo:lo + n], xs[lo:lo + n], ys[lo:lo + n],
                    rows[lo:lo + n, 1], rows[lo:lo + n, 2]))
        lo += n
    return out


def _read_blocks(pool, reads: int, alpha: float, gen) -> list:
    """Each read block's ``(tenants, query rows (reads, Q, d))`` on the
    host."""
    bank, dev = pool.xq.shape[1], pool.xq.device
    rank = torch.randperm(bank, generator=gen, device=dev)
    weight = torch.empty(bank, device=dev)
    weight[rank] = torch.arange(1, bank + 1, device=dev,
                                dtype=torch.float32) ** -alpha
    out = []
    for r in range(pool.read_blocks):
        tenants = torch.multinomial(weight, reads, replacement=False,
                                    generator=gen)
        out.append((tenants.tolist(), pool.xq[r][tenants].cpu().numpy()))
    return out


class Client:
    """The client: one round at a time, each call a request."""

    def __init__(self, cell, system, inputs, seed, device):
        w, b, pool = inputs.w, inputs.b, inputs.pool
        cfg, traffic = cell.cfg, cell.traffic
        self.reads = int(cell.mix["reads_per_round"])
        if traffic.inflight != 1 or not traffic.queries or not (
                0 < self.reads <= cfg["bank"]):
            raise ValueError("the facade driver takes inflight 1, queries "
                             "and 1 to B reads a round")
        self.system = (system or ProgramServer)(cell, w, b)
        self.cell, self.pool, self.traffic = cell, pool, traffic
        self.cuda = torch.device(device).type == "cuda"
        gen = torch.Generator(device=device)
        gen.manual_seed((seed ^ 0xFACADE) & _MASK64)
        self.writes = _write_blocks(pool, gen)
        self.queries = _read_blocks(pool, self.reads, traffic.zipf_alpha, gen)
        sched = pool.schedule
        self.resets = [sched.slots(j).tolist() for j in range(sched.groups)]
        # Answers of the last stream_rounds rounds stay for the comparison.
        self.ring = sched.stream_rounds + 1
        self.answers = {}
        self.rbuf = torch.zeros(self.ring, cfg["bank"], traffic.queries,
                                pin_memory=self.cuda)
        self.rmask = torch.zeros(self.ring, cfg["bank"], dtype=torch.bool)
        self.rev = [Event(self.cuda) for _ in range(self.reads)]
        self.g = 0
        self.run = None  # set for the measured window

    def step(self):
        g, pool, sysm, clock = self.g, self.pool, self.system, time.perf_counter
        tenants, xs, ys, _, _ = self.writes[g % pool.blocks]
        grp = pool.schedule.reset_group(g)
        if grp is not None:
            with torch.profiler.record_function("portbench.reset"):
                for slot in self.resets[grp]:
                    sysm.reset_tenant(slot)
        sent = [0.0] * len(tenants)
        with torch.profiler.record_function("portbench.submit"):
            for i, tenant in enumerate(tenants):
                sent[i] = clock()
                sysm.submit(tenant, xs[i], ys[i])
        with torch.profiler.record_function("portbench.write"):
            self.answers[g] = sysm.flush()
        flushed = clock()
        self.answers.pop(g - self.ring, None)

        slot = g % self.ring
        read, xq = self.queries[g % pool.read_blocks]
        rbuf, events = self.rbuf[slot], self.rev
        called, seen = [0.0] * len(read), [0.0] * len(read)
        oldest = 0
        for j, tenant in enumerate(read):
            called[j] = clock()
            with torch.profiler.record_function("portbench.read"):
                out = sysm.predict(tenant, xq[j])
            rbuf[tenant].copy_(out, non_blocking=True)
            events[j].record()
            while oldest <= j and events[oldest].query():
                seen[oldest] = clock()
                oldest += 1
        with torch.profiler.record_function("portbench.collect"):
            while oldest < len(read):
                events[oldest].synchronize()
                seen[oldest] = clock()
                oldest += 1
        self.rmask[slot].zero_()
        self.rmask[slot, read] = True
        self.g += 1
        run = self.run
        if run is None:
            return
        run.writes += len(tenants)
        run.obs += len(tenants)
        run.write_latency_s.extend(flushed - t for t in sent)
        run.reads += len(read)
        run.read_latency_s.extend(s - c for s, c in zip(seen, called))

    def rounds(self, n: int):
        for _ in range(n):
            self.step()

    def drain(self):
        """Nothing is outstanding between rounds."""

    def results(self, g: int):
        _, _, _, tenants, ticks = self.writes[g % self.pool.blocks]
        pred, err = scatter(self.answers[g], tenants, ticks,
                            self.pool.mask.shape[1:])
        slot = g % self.ring
        return pred, err, self.rbuf[slot], self.rmask[slot]

    def leaves(self) -> dict:
        return self.system.leaves()

    def release(self):
        self.system = None

    def costs(self, run, first: int, last: int):
        """Operations and bounds of rounds ``first..last-1`` into ``run``: a
        flush is one write of its block, a predict one read of ``queries``
        rows of one tenant (its theta row read once)."""
        add_write_costs(run, self.cell, self.pool, first, last)
        if run.reads:
            q = self.traffic.queries
            ops, nbytes = self.cell.counts.read({**self.cell.cfg, "bank": 1}, q)
            run.read_rows = q * run.reads
            run.read_ops = ops * run.reads
            run.read_bound_s = bound_s(run, ops, nbytes) * run.reads
