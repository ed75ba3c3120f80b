"""The harness on the CPU at a tiny size: the program passes, the control
and the planted faults do not; the result line's keys; the import guard;
new configurations, mixes and metrics are found by name; the trace
reader; and, on the card, the control at the cells' own size."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, tracing
from portbench.system import ControlSystem, ProgramSystem
from portbench_tiny import REPO, tiny_bench

CELLS = ["klms-read-heavy", "krls-write-dense"]
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("portbench"))


def _run(root, cell, system=None, trace=False, rounds=24):
    return harness.run_cell(root, cell, SEED, 0, trace, "cpu",
                            system=system, rounds=rounds)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 24 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert any(k.split(".")[0] == "obs_per_s" for k in r["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    r = _run(root, cell, system=ControlSystem)
    assert not r["correct"], r["checks"]


class _Unchanged(ProgramSystem):
    """A write that returns its state unchanged."""

    def write(self, state, xs, ys, mask):
        _, pred, err = super().write(state, xs, ys, mask)
        return state, pred, err


class _HalfBatch(ProgramSystem):
    """Half of the bank left out of each write, its outputs the mean of
    the rest."""

    def write(self, state, xs, ys, mask):
        half = xs.shape[0] // 2
        keep = mask.clone()
        keep[half:] = 0
        state, pred, err = super().write(state, xs, ys, keep)
        pred, err = pred.clone(), err.clone()
        pred[half:] = pred[:half].mean()
        err[half:] = err[:half].mean()
        return state, pred, err


class _Altered(ProgramSystem):
    """One live answer of each write changed where it is produced by a
    tenth of the targets' spread, one of each read by 1."""

    def write(self, state, xs, ys, mask):
        state, pred, err = super().write(state, xs, ys, mask)
        live = torch.nonzero(mask > 0)
        if len(live):
            pred = pred.clone()
            b, t = live[len(live) // 2].tolist()
            pred[b, t] += 0.1 * float(ys.std())
        return state, pred, err

    def read(self, state, xq):
        out = super().read(state, xq).clone()
        out[5, 0] += 1.0
        return out


@pytest.mark.parametrize("fault", [_Unchanged, _HalfBatch, _Altered])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(root, cell, fault):
    r = _run(root, cell, system=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_traced_run_reports_per_layer_metrics(root):
    r = _run(root, "klms-read-heavy", trace=True)
    assert r["correct"]
    assert {"write_dispatch_ms", "read_dispatch_ms",
            "bank_mfu.reads"} <= set(r["metrics"])
    assert "obs_per_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("queries", [3, 0])
def test_new_files_are_found_by_name(root, queries):
    """A configuration, a traffic mix (with reads, and with none), a
    metric and a cell added as new files and entries, with no file that
    is there edited; the control in its place is not correct."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/klms-d128-D2048.json")
                     .read_text())
    cfg.update(name="klms-new", num_features=32)
    (root / "portbench/configs/klms-new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/read-heavy.json").read_text())
    mix.update(queries=queries, active_share=0.75,
               pool_read_blocks=4 if queries else 0)
    (root / "portbench/traffic/new-mix.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/rounds_per_s.py").write_text(
        "def read(run):\n    return run.writes / run.window_s\n")
    (root / "portbench/limits/klms-new-cell.json").write_text(
        (root / "portbench/limits/klms-read-heavy.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "klms-new",
                             "file": "portbench/configs/klms-new.json"})
    bench["workloads"].append({"name": "klms-new-cell", "config": "klms-new",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "rounds_per_s", "unit": "rounds/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["klms-new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        r = _run(root, "klms-new-cell")
        assert r["correct"], r["checks"]
        assert r["metrics"]["rounds_per_s"]["value"] > 0
        assert "reads_per_s" not in r["metrics"]  # not listed for it
        assert r["attempted"] == 24 * (2 if queries else 1)
        r = _run(root, "klms-new-cell", system=ControlSystem)
        assert not r["correct"], r["checks"]
        r = _run(root, "klms-read-heavy")
        assert "rounds_per_s" not in r["metrics"]
    finally:
        bench["configs"].pop()
        bench["workloads"].pop()
        bench["end_to_end"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_import_guard():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve", "numpy", "reprox"]) == []
    assert harness.forbidden_modules(
        ["repro.core.bank", "jax._src.api", "jaxlib", "flax.linen"]) == [
            "flax", "jax", "jaxlib", "repro"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert proc.returncode != 0 and proc.stdout == ""


def test_trace_summary():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.write",
         "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.collect",
         "ts": 20, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 20,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70,
         "dur": 20, "args": {"correlation": 9}},
    ]
    s = tracing.summarize(ev)
    assert s.busy_s == pytest.approx(60e-6)
    assert s.span_device_s == {"portbench.write": pytest.approx(50e-6)}
    assert s.device_ops[0] == ["k1", pytest.approx(30e-6)]
    assert s.idle_gaps == [["portbench.collect", pytest.approx(20e-6)]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell):
    """The control (the reference in float32 with TF32 products in the
    program's place) over a whole session of rounds at the cell's own
    size, on three seeds: never correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from portbench import spec

    c = spec.load_cell(REPO, cell)
    sched_rounds = c.traffic.stream_ticks // c.cfg["chunk"]
    for seed in (11, 2 ** 31 + 5, 3 * 10 ** 9 + 1):
        r = harness.run_cell(REPO, cell, seed, 0, False, "cuda",
                             system=ControlSystem, rounds=sched_rounds + 8)
        print(cell, seed, json.dumps(r["checks"]))
        assert not r["correct"], r["checks"]
