"""One run of one cell: set-up, warm-up, the measured window, the readers
and the comparison.

The window is a closed loop of rounds for one client: the cell's driver
(``drivers/<driver>.py``, named by its traffic mix) builds the system,
issues and collects the rounds and fills the :class:`Run`; the cell's
family (``families/<family>.py``) makes the inputs from the seed and
gives the numbers compared; the window's clock, the trace, the readers
and the judgment are the same for every cell. A driver module has
``FIELDS`` (the mix's fields beyond the family's), optionally ``SPANS``
(the ``record_function`` ranges its client opens; ``tracing.SPANS`` where
it names none) and ``Client(cell, system, inputs, seed, device)`` with
``g`` (rounds issued), ``cuda``, ``run`` (the window's :class:`Run`, None
outside it), ``step()``, ``drain()``, ``rounds(n)``, ``results`` (what
the family's ``compare`` reads of the rounds), ``leaves()``,
``release()`` and ``costs(run, first, last)``. ``system`` replaces the
program with a class of the driver's calls (the control, a planted
fault), or is None.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import compare, program_trace, spec, tracing

__all__ = ["FORBIDDEN", "Event", "Run", "bound_s", "forbidden_modules",
           "run_cell"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Event:
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

    def query(self) -> bool:
        return self.ev is None or self.ev.query()


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
    trace: tracing.TraceSummary = None        # by the driver's ranges
    program: program_trace.ProgramTrace = None  # by every span kept


def bound_s(run: Run, ops: float, nbytes: float) -> float:
    """The least time the chip takes for ``ops`` operations and ``nbytes``
    bytes: the larger of the two over their peaks."""
    return max(ops / run.peaks["f32_ops_per_s"],
               nbytes / run.peaks["hbm_bytes_per_s"])


def _read_metrics(readers: dict, run: Run) -> dict:
    out = {}
    for name, (entry, mod) in readers.items():
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": entry["unit"]}
    return out


def _profile_window(loop, seconds, rounds, spans, prefixes):
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
    return (window_s, tracing.summarize(events, spans),
            program_trace.summarize(events, spans, prefixes))


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
    replaces the program (a class with the calls the cell's driver makes,
    built as the driver builds the program's), ``rounds`` the ``seconds``
    of the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts = {"start": time.perf_counter() - t_start}
    mem = {}  # device bytes (allocated, peak so far) after a set-up part
    cell = spec.load_cell(Path(root), workload)
    cfg, traffic = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = cell.family.make_inputs(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["pool"] = time.perf_counter() - t_start
    if cuda:
        mem["pool"] = [torch.cuda.memory_allocated(dev),
                       torch.cuda.max_memory_allocated(dev)]
    loop = cell.driver.Client(cell, system, inputs, seed, dev)
    parts["system"] = time.perf_counter() - t_start
    loop.rounds(traffic.warmup_rounds)
    if cuda:
        torch.cuda.synchronize(dev)
    parts["warmup"] = time.perf_counter() - t_start
    if cuda:
        mem["warmup"] = [torch.cuda.memory_allocated(dev),
                         torch.cuda.max_memory_allocated(dev)]
    mem["state"] = sum(v.numel() * v.element_size() for v in
                       loop.leaves().values())
    peaks = json.loads((spec.HERE / "peaks.json").read_text())
    run = Run(peaks=peaks, setup_s=time.perf_counter() - t_start)
    loop.run = run
    first = loop.g
    if trace:
        run.window_s, run.trace, run.program = _profile_window(
            loop, seconds, rounds, getattr(cell.driver, "SPANS",
                                           tracing.SPANS),
            cell.family.PREFIXES)
    else:
        run.window_s = _window(loop, seconds, rounds)
    loop.run = None
    loop.costs(run, first, loop.g)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics = _read_metrics(cell.per_layer if trace else cell.metrics, run)
    described = cell.family.describe(inputs)
    leaves = {k: v.detach().clone() for k, v in loop.leaves().items()}
    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.family.compare(cell, inputs, loop.results, loop.g, leaves,
                                  seed, dev)
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
               "pool": described}
    if run.trace is not None:
        summary["trace"] = {"span_device_s": run.trace.span_device_s,
                            "span_ops": run.trace.span_ops,
                            "device_events": run.trace.device_events}
        summary["program"] = {
            name: {k: s[k] for k in ("count", "device_s", "idle_s")}
            for name, s in run.program.spans.items()}
    print(f"portbench: {workload} seed {seed}: {json.dumps(summary)}",
          file=log)
    return result
