"""The driver seam and the facade driver on the CPU at a tiny size: a mix's
``driver`` names the client (``lockstep`` where it names none); the
facade cell, added as entries alone, comes out correct, and its control
and three faults (a submit dropped, a predict answered before its round's
flush, a reset skipped) do not; a flush's answers go back to the live
ticks of a ragged block; the submit order; the facade's span readers."""
import json
import math

import pytest
import torch

from portbench import harness, program_trace, spec
from portbench.generator import Traffic, make_pool
from portbench_tiny import REPO, tiny_bench

CELL = "klms-facade-ragged"
SEED = 2 ** 31 + 41
FACADE = spec.load_module(spec.HERE, "drivers", "facade")


def add_facade_cell(root):
    """The facade cell's entries in ``root``'s ``BENCHMARK.json``: the
    workload on the KLMS configuration and the end-to-end metrics and
    per-layer readers that list it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if any(w["name"] == CELL for w in bench["workloads"]):
        return
    bench["workloads"].append({
        "name": CELL, "config": "klms-d128-D2048", "traffic": "facade-ragged",
        "chips": 1, "why": "make_server per request"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    for name in ("write_kernel_roofline", "read_kernel_roofline",
                 "write_wait_ms", "write_host_ms"):
        next(m for m in bench["per_layer"] if m["name"] == name)[
            "workloads"].append(CELL)
    for name, unit, better, source, layer, moves in [
            ("submit_host_us", "us", "lower", "program_span",
             "serving facade", "obs_per_s"),
            ("flush_host_ms", "ms", "lower", "program_span",
             "serving facade", "obs_per_s"),
            ("predict_host_ms", "ms", "lower", "program_span",
             "serving facade", "reads_per_s"),
            ("bank_mfu.facade", "%", "higher", "device_trace", "whole round",
             "obs_per_s"),
            ("device_idle_pct.facade", "%", "lower", "device_trace", "device",
             "obs_per_s")]:
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": moves, "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_bench(tmp_path_factory.mktemp("portbench"))
    add_facade_cell(root)
    return root


def _run(root, system=None, rounds=12):
    return harness.run_cell(root, CELL, SEED, 0, False, "cpu", system=system,
                            rounds=rounds)


def test_a_mix_names_its_driver(root):
    """No ``driver``: the lockstep client; ``facade``: the facade client;
    a field that is neither the generator's nor the driver's, or a driver
    with no file, is refused."""
    lock = spec.load_cell(root, "klms-read-heavy")
    assert "driver" not in lock.mix
    assert lock.driver.__file__.endswith("drivers/lockstep.py")
    assert spec.load_cell(REPO, "krls-write-dense").driver.FIELDS == ()
    fac = spec.load_cell(root, CELL)
    assert fac.driver.__file__.endswith("drivers/facade.py")
    assert fac.mix["reads_per_round"] == 6
    assert fac.traffic.queries == 8 and fac.traffic.inflight == 1
    path = root / "portbench/traffic/facade-ragged.json"
    mix = path.read_text()
    try:
        path.write_text(json.dumps({**json.loads(mix), "burst": 3}))
        with pytest.raises(ValueError, match="burst"):
            spec.load_cell(root, CELL)
        path.write_text(json.dumps({**json.loads(mix), "driver": "absent"}))
        with pytest.raises(FileNotFoundError):
            spec.load_cell(root, CELL)
    finally:
        path.write_text(mix)


def test_facade_cell_is_correct(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"write_gap", "read_gap", "theta_gap",
                                "step_mismatch"}
    c = spec.load_cell(root, CELL)
    pool = make_pool(c.traffic, 16, 4, 8, (SEED ^ 0x5EED) & ((1 << 63) - 1),
                     "cpu")
    # Every submit and every predict of the window's 12 rounds (after 4
    # warm-up rounds) is a request.
    assert r["attempted"] == sum(pool.live[4:16]) + 12 * 6
    assert {"obs_per_s", "reads_per_s", "write_p95_ms", "read_p95_ms",
            "setup_s"} == set(r["metrics"])


def test_control_is_not_correct(root):
    r = _run(root, system=FACADE.ControlServer)
    assert not r["correct"], r["checks"]


class _Faulty(FACADE.ProgramServer):
    """A fault armed by each flush (and at the start), so that each round
    has one."""

    armed = True

    def flush(self):
        self.armed = True
        return super().flush()


class _DroppedSubmit(_Faulty):
    """A round's first submit never reaches the server."""

    def submit(self, tenant, x, y):
        if self.armed:
            self.armed = False
            return
        super().submit(tenant, x, y)


class _EarlyPredict(_Faulty):
    """A round's first predict answered from the replica its flush
    replaced, as if made before the flush."""

    def flush(self):
        self.before = self.server.snapshot_server.snapshot
        return super().flush()

    def predict(self, tenant, xq):
        if not self.armed:
            return super().predict(tenant, xq)
        self.armed = False
        inner = self.server.snapshot_server
        now, inner._snapshot = inner.snapshot, self.before
        try:
            return super().predict(tenant, xq)
        finally:
            inner._snapshot = now


class _SkippedReset(_Faulty):
    """A round's first reset not made."""

    def reset_tenant(self, tenant):
        if self.armed:
            self.armed = False
            return
        super().reset_tenant(tenant)


@pytest.mark.parametrize("fault", [_DroppedSubmit, _EarlyPredict,
                                   _SkippedReset])
def test_faults_are_not_correct(root, fault):
    r = _run(root, system=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_scatter_puts_answers_at_the_live_ticks():
    """A hand-made ragged block of 4 slots and 3 ticks: slot 0 live at
    ticks 0 and 2, slot 2 at 1, slot 3 at 0, 1 and 2."""
    tenants, ticks = [0, 0, 2, 3, 3, 3], [0, 2, 1, 0, 1, 2]
    answers = {3: [(5.0, -5.0), (6.0, -6.0), (7.0, -7.0)],
               0: [(1.0, -1.0), (2.0, -2.0)], 2: [(3.0, -3.0)]}
    pred, err = FACADE.scatter(answers, tenants, ticks, (4, 3))
    assert pred.tolist() == [[1, 0, 2], [0, 0, 0], [0, 3, 0], [5, 6, 7]]
    assert torch.equal(err, -pred)
    # A slot answered short reads NaN at its live ticks, the rest stand.
    pred, _ = FACADE.scatter({**answers, 3: answers[3][:2]}, tenants, ticks,
                             (4, 3))
    assert all(math.isnan(pred[3, t]) for t in range(3))
    assert pred[:3].tolist() == [[1, 0, 2], [0, 0, 0], [0, 3, 0]]
    # A slot answered with no live tick: the whole block NaN.
    pred, _ = FACADE.scatter({**answers, 1: [(9.0, 9.0)]}, tenants, ticks,
                             (4, 3))
    assert all(math.isnan(pred[b, t]) for b, t in zip(tenants, ticks))


def _pool():
    t = Traffic(inflight=1, queries=2, active_share=0.5, zipf_alpha=0.9,
                stream_ticks=32, reset_every=2, noise_std=0.05,
                warmup_rounds=2, pool_sessions=2, pool_read_blocks=3)
    return make_pool(t, 16, 4, 5, 7, "cpu")


def _orders(pool, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return FACADE._write_blocks(pool, gen)


def test_submit_order_keeps_each_tenants_ticks_in_time_order():
    pool = _pool()
    blocks = _orders(pool, 3)
    for k, (tenants, xs, ys, lb, lt) in enumerate(blocks):
        assert sorted(tenants) == sorted(lb.tolist())
        for b in set(tenants):
            mine = [i for i, s in enumerate(tenants) if s == b]
            want = lt[lb == b]
            assert torch.equal(torch.from_numpy(xs[mine]),
                               pool.xs[k, b, want])
            assert ys[mine[0]] == float(pool.ys[k, b, want[0]])
    again = _orders(pool, 3)
    assert all(a[0] == b[0] for a, b in zip(blocks, again))
    other = _orders(pool, 4)
    assert any(a[0] != b[0] for a, b in zip(blocks, other))


def test_read_draw_takes_distinct_tenants():
    pool = _pool()
    gen = torch.Generator()
    gen.manual_seed(5)
    blocks = FACADE._read_blocks(pool, 6, 0.9, gen)
    assert len(blocks) == pool.read_blocks
    for r, (tenants, xq) in enumerate(blocks):
        assert len(set(tenants)) == 6
        assert torch.equal(torch.from_numpy(xq), pool.xq[r][tenants])


@pytest.mark.parametrize("totals,expect", [
    (None, (None, None, None)),
    ({}, (None, None, None)),
    ({("serve.submit",): (4, 2e-4),
      ("serve.flush", "queue.flush"): (2, 6e-3),
      ("serve.flush", "queue.flush", "lockstep.write"): (2, 2e-3),
      ("serve.predict",): (8, 4e-3)}, (50.0, 2.0, 0.5)),
])
def test_facade_span_readers(monkeypatch, totals, expect):
    monkeypatch.setattr(program_trace, "program_spans",
                        lambda: None if totals is None
                        else program_trace.SpanTotals(totals))
    run = harness.Run(peaks={}, window_s=1.0)
    for name, want in zip(("submit_host_us", "flush_host_ms",
                           "predict_host_ms"), expect):
        got = spec.load_module(REPO / "portbench", "metrics", name).read(run)
        assert got == (want if want is None else pytest.approx(want)), name


@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_the_card(tmp_path):
    """The control (the reference in float32 with TF32 products behind the
    client's calls) at the cell's own size, over 48 rounds (a 10 s window
    of the program makes ~40 after its 9 warm-up rounds), on three seeds:
    never correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    import shutil

    root = tmp_path / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_facade_cell(root)
    for seed in (13, 2 ** 31 + 7, 3 * 10 ** 9 + 3):
        r = harness.run_cell(root, CELL, seed, 0, False, "cuda",
                             system=FACADE.ControlServer, rounds=48)
        print(CELL, seed, json.dumps(r["checks"]))
        assert not r["correct"], r["checks"]
