"""One run of one cell: set-up, warm-up, the measured window, the readers
and the comparison.

The window is a closed loop of rounds for one client that keeps
``inflight`` rounds outstanding. Round g: the reset of the slots whose
sessions start at g (one ``reset_slots`` call every ``reset_every``
rounds), one write block through the chunk step on the state the last
round left, then, where the mix has queries, one read block on the state
this write returned. Each result (the write's prior predictions and
errors, the read's predictions) is copied into pinned host memory without
blocking and an event is recorded after the copy; the client collects the
oldest round by its events, so collecting one request never waits for
work queued after it. A request's latency runs from the host clock before
its call to the host clock once its event has completed. Inputs come from
the pool made in set-up: nothing crosses from the host in the window.
"""
from __future__ import annotations

import collections
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import compare, generator, spec, tracing
from portbench.system import ProgramSystem

__all__ = ["FORBIDDEN", "forbidden_modules", "run_cell", "Run"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_MASK64 = (1 << 63) - 1


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def make_map(cfg: dict, seed: int, device) -> tuple:
    """The feature map's W ``(d, D) ~ N(0, I / sigma^2)`` and b ``(D,) ~
    U(0, 2 pi)``, made by the benchmark from the seed, on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _MASK64)
    d, dfeat = cfg["input_dim"], cfg["num_features"]
    w = torch.randn(d, dfeat, generator=gen, device=device) / cfg["sigma"]
    b = torch.rand(dfeat, generator=gen, device=device) * (2.0 * math.pi)
    return w.contiguous(), b.contiguous()


class _Event:
    """A CUDA event, or nothing on the CPU (where every call is done when
    it returns)."""

    def __init__(self, cuda: bool):
        self.ev = torch.cuda.Event() if cuda else None

    def record(self):
        if self.ev is not None:
            self.ev.record()

    def synchronize(self):
        if self.ev is not None:
            self.ev.synchronize()


@dataclass
class Run:
    """What the window measured, for the metric readers."""

    peaks: dict
    window_s: float = 0.0
    setup_s: float = 0.0
    writes: int = 0
    reads: int = 0
    obs: int = 0
    read_rows: int = 0
    write_ops: float = 0.0
    read_ops: float = 0.0
    write_bound_s: float = 0.0
    read_bound_s: float = 0.0
    write_latency_s: list = field(default_factory=list)
    read_latency_s: list = field(default_factory=list)
    write_dispatch_s: list = field(default_factory=list)
    read_dispatch_s: list = field(default_factory=list)
    trace: tracing.TraceSummary = None


class Loop:
    """The client: issues rounds and collects them in order."""

    def __init__(self, cell, system, pool, device):
        cfg, traffic = cell.cfg, cell.traffic
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
        self.wev = [_Event(self.cuda) for _ in range(self.ring)]
        self.rev = [_Event(self.cuda) for _ in range(self.ring)]
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
        slot = g % self.ring
        reads = self.rbuf[slot] if self.rbuf is not None else None
        return self.wbuf[slot, 0], self.wbuf[slot, 1], reads


def _costs(cell, pool, run: Run, first: int, last: int):
    """Operations and bounds of rounds ``first..last-1`` into ``run``."""
    peak_ops, peak_bw = run.peaks["f32_ops_per_s"], run.peaks["hbm_bytes_per_s"]
    cfg, counts = cell.cfg, cell.counts
    per_block = [counts.write(cfg, pool.live[k], pool.active[k])
                 for k in range(pool.blocks)]
    for g in range(first, last):
        ops, nbytes = per_block[g % pool.blocks]
        run.write_ops += ops
        run.write_bound_s += max(ops / peak_ops, nbytes / peak_bw)
    if run.reads:
        rows = cfg["bank"] * cell.traffic.queries
        ops, nbytes = counts.read(cfg, rows)
        run.read_rows = rows * run.reads
        run.read_ops = ops * run.reads
        run.read_bound_s = max(ops / peak_ops, nbytes / peak_bw) * run.reads


def _read_metrics(readers: dict, run: Run) -> dict:
    out = {}
    for name, (entry, mod) in readers.items():
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": entry["unit"]}
    return out


def _profile_window(loop, seconds, rounds):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if loop.cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        window_s = _window(loop, seconds, rounds)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = tracing.read_chrome_trace(path)
    return window_s, tracing.summarize(events)


def _window(loop, seconds, rounds) -> float:
    t0 = time.perf_counter()
    if rounds is not None:
        for _ in range(rounds):
            loop.step()
    else:
        end = t0 + seconds
        while time.perf_counter() < end:
            loop.step()
    loop.drain()
    return time.perf_counter() - t0


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", *, t_start: float = None, system=None,
             rounds: int = None, log=sys.stderr) -> dict:
    """Run ``workload`` once; returns the result line's object. ``system``
    replaces the program (a class taking ``(cell, w, b)``), ``rounds``
    the ``seconds`` of the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts = {"start": time.perf_counter() - t_start}
    mem = {}  # device bytes (allocated, peak so far) after a set-up part
    cell = spec.load_cell(Path(root), workload)
    cfg, traffic = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, b = make_map(cfg, seed, dev)
    pool = generator.make_pool(traffic, cfg["bank"], cfg["chunk"],
                               cfg["input_dim"], (seed ^ 0x5EED) & _MASK64,
                               dev)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["pool"] = time.perf_counter() - t_start
    if cuda:
        mem["pool"] = [torch.cuda.memory_allocated(dev),
                       torch.cuda.max_memory_allocated(dev)]
    loop = Loop(cell, (system or ProgramSystem)(cell, w, b), pool, dev)
    parts["system"] = time.perf_counter() - t_start
    loop.rounds(traffic.warmup_rounds)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["warmup"] = time.perf_counter() - t_start
    if cuda:
        mem["warmup"] = [torch.cuda.memory_allocated(dev),
                         torch.cuda.max_memory_allocated(dev)]
    mem["state"] = sum(v.numel() * v.element_size() for v in
                       loop.system.leaves(loop.state).values())
    peaks = json.loads((spec.HERE / "peaks.json").read_text())
    run = Run(peaks=peaks, setup_s=time.perf_counter() - t_start)
    loop.run = run
    first = loop.g
    if trace:
        run.window_s, run.trace = _profile_window(loop, seconds, rounds)
    else:
        run.window_s = _window(loop, seconds, rounds)
    loop.run = None
    _costs(cell, pool, run, first, loop.g)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics = _read_metrics(cell.per_layer if trace else cell.metrics, run)
    leaves = {k: v.detach().clone() for k, v in
              loop.system.leaves(loop.state).items()}
    loop.state = None
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare.replay(cell, pool, w, b, loop.results, loop.g, leaves)
    correct = compare.judge(numbers, cell.limits)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.entry.get("chips", 1),
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": correct, "attempted": run.writes + run.reads,
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = compare.format_checks(numbers, cell.limits)
    summary = {"rounds": loop.g - first, "warmup_rounds": first,
               "setup_parts_s": parts, "setup_device_bytes": mem,
               "pool": generator.describe(pool)}
    if run.trace is not None:
        summary["trace"] = {"span_device_s": run.trace.span_device_s,
                            "span_ops": run.trace.span_ops,
                            "device_events": run.trace.device_events}
    print(f"portbench: {workload} seed {seed}: {json.dumps(summary)}",
          file=log)
    return result
