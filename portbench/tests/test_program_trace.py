"""The readers of the program's own spans: the chrome-trace reader on a
synthetic trace, the program's profiled totals, and the ``program_span``
metrics in traced CPU runs of both cells."""
import pytest

from portbench import harness, program_trace, spec, tracing
from portbench_tiny import REPO, tiny_bench

CELLS = ["klms-read-heavy", "krls-write-dense"]
SEED = 2 ** 31 + 29
PROGRAM_METRICS = ("write_wait_ms", "write_host_ms", "read_host_ms")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("portbench"))


def _reader(name):
    return spec.load_module(REPO / "portbench", "metrics", name)


def _annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _op(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_program_trace_nests_the_programs_spans():
    """Two writes, each ``portbench.write`` > ``lockstep.write`` >
    (``kernel.klms_chunk``, then ``host.wait``), a reset and a collect: the
    counts, self times, time of one span inside another, device time by
    every enclosing span, and each idle gap put down to the innermost range
    open at its start."""
    ev = [
        _annotation("portbench.write", 0, 100),
        _annotation("lockstep.write", 5, 90),
        _annotation("kernel.klms_chunk", 10, 20),
        _annotation("host.wait", 40, 50),
        _launch(12, 1), _launch(45, 2),
        _op("k1", 20, 30, 1), _op("Memcpy HtoD", 50, 10, 2),
        _annotation("portbench.write", 200, 100),
        _annotation("lockstep.write", 205, 90),
        _annotation("kernel.klms_chunk", 210, 20),
        _annotation("host.wait", 240, 50),
        _launch(212, 3), _op("k1", 300, 30, 3),
        _annotation("portbench.reset", 400, 30),
        _annotation("lockstep.reset", 405, 20),
        _launch(410, 4), _op("clone", 420, 40, 4),
        _annotation("portbench.collect", 325, 60),
    ]
    p = program_trace.summarize(ev)
    s = p.spans
    assert s["lockstep.write"]["count"] == 2
    assert s["lockstep.write"]["total_s"] == pytest.approx(180e-6)
    assert s["lockstep.write"]["self_s"] == pytest.approx(40e-6)
    assert s["portbench.write"]["self_s"] == pytest.approx(20e-6)
    assert p.within["lockstep.write"]["host.wait"] == pytest.approx(100e-6)
    assert p.within["portbench.write"]["kernel.klms_chunk"] == (
        pytest.approx(40e-6))
    assert "portbench.write" not in p.within.get("lockstep.write", {})
    for name in ("portbench.write", "lockstep.write"):
        assert s[name]["device_s"] == pytest.approx(70e-6), name
    assert s["kernel.klms_chunk"]["device_s"] == pytest.approx(60e-6)
    assert s["host.wait"]["device_s"] == pytest.approx(10e-6)
    assert s["lockstep.reset"]["device_s"] == pytest.approx(40e-6)
    assert s["portbench.reset"]["device_s"] == pytest.approx(40e-6)
    # Busy 20-60, 300-330, 420-460: the gap from 60 begins in host.wait
    # (inside lockstep.write and portbench.write), the one from 330 in
    # portbench.collect.
    assert p.idle_gaps == [["host.wait", pytest.approx(240e-6)],
                           ["portbench.collect", pytest.approx(90e-6)]]
    assert s["host.wait"]["idle_s"] == pytest.approx(240e-6)
    assert s["lockstep.write"]["idle_s"] == pytest.approx(240e-6)
    assert s["portbench.collect"]["idle_s"] == pytest.approx(90e-6)
    assert p.per_call_ms("lockstep.write", 100e-6) == pytest.approx(0.05)
    assert p.per_call_ms("lockstep.read", 1.0) is None


def test_program_trace_without_program_spans():
    """The harness's ranges alone (a program without spans): no program
    span, and the gaps as the harness's own reader puts them; the
    harness's reader is blind to the program's ranges."""
    ev = [_annotation("portbench.write", 0, 10), _launch(2, 7),
          _op("k1", 5, 10, 7), _annotation("portbench.collect", 20, 50),
          _launch(22, 8), _op("k2", 40, 5, 8)]
    p = program_trace.summarize(ev)
    assert set(p.spans) == {"portbench.write", "portbench.collect"}
    assert p.within == {}
    assert p.idle_gaps == tracing.summarize(ev).idle_gaps
    prog = [_annotation("lockstep.write", 1, 8),
            _annotation("host.wait", 30, 50)]
    assert tracing.summarize(ev + prog) == tracing.summarize(ev)


def test_span_totals_by_nesting_path():
    """Counts and seconds by name, nested anywhere in another span or not,
    and per call."""
    t = program_trace.SpanTotals({
        ("lockstep.write",): (4, 8e-3),
        ("lockstep.write", "kernel.klms_chunk"): (4, 2e-3),
        ("lockstep.write", "kernel.klms_chunk", "host.wait"): (4, 5e-3),
        ("lockstep.reset",): (1, 1e-3),
        ("lockstep.reset", "host.wait"): (3, 0.5e-3),
        ("lockstep.read",): (2, 1e-3),
    })
    assert t.count("lockstep.write") == 4 and t.count("host.wait") == 7
    assert t.seconds("host.wait") == pytest.approx(5.5e-3)
    assert t.seconds("host.wait", inside="lockstep.write") == (
        pytest.approx(5e-3))
    assert t.seconds("host.wait", inside="lockstep.read") == 0.0
    assert t.per_call_ms("lockstep.read", 1e-3) == pytest.approx(0.5)
    assert t.per_call_ms("lockstep.absent", 1.0) is None


@pytest.mark.parametrize("totals,expect", [
    (None, (None, None, None)),
    ({}, (None, None, None)),
    ({("lockstep.write",): (4, 8e-3),
      ("lockstep.write", "kernel.klms_chunk", "host.wait"): (4, 6e-3),
      ("lockstep.read",): (2, 1e-3)}, (1.5, 0.5, 0.5)),
    ({("lockstep.write",): (2, 1e-3)}, (0.0, 0.5, None)),
])
def test_program_span_readers(monkeypatch, totals, expect):
    """Each reader gives its per-call milliseconds from the program's
    totals; None where the program keeps none or has no such span (the
    harness then leaves the metric out), 0.0 where no write waits."""
    monkeypatch.setattr(program_trace, "program_spans",
                        lambda: None if totals is None
                        else program_trace.SpanTotals(totals))
    run = harness.Run(peaks={}, window_s=1.0)
    for name, want in zip(PROGRAM_METRICS, expect):
        got = _reader(name).read(run)
        assert got == (want if want is None else pytest.approx(want)), name


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_programs_spans(root, cell):
    """A traced CPU run reports the program's span readings (no device: no
    wait) beside the harness's own, which are computed as before."""
    from repro_torch.obs import trace

    trace.clear_profiled_spans()
    r = harness.run_cell(root, cell, SEED, 0, True, "cpu", rounds=24)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["write_wait_ms"] == 0.0
    assert 0 < m["write_host_ms"] <= m["write_dispatch_ms"]
    assert 0 < m["read_host_ms"] <= m["read_dispatch_ms"]
    assert {"write_dispatch_ms", "read_dispatch_ms"} <= set(m)
    assert {"write_kernel_roofline", "read_kernel_roofline"}.isdisjoint(m)
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # Only the window was profiled: one lockstep.write a round.
    totals = program_trace.program_spans()
    assert totals.count("lockstep.write") == 24
    assert totals.count("lockstep.read") == 24
