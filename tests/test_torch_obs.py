"""The port's observability tier (``repro_torch.obs``, the traced and probed
server) held against ``repro`` on the CPU.

* The tracer: with the same fake clock and the same spans, ``to_jsonl``
  text and ``to_chrome_trace`` dicts equal ``repro``'s; ring overflow and
  zero capacity as ``repro``'s; a traced server's Chrome export passes the
  repo's trace validator (scripts/check_bench_schema.py).
* The probes: ``stats_tap`` and ``slot_stats`` on the same numpy KLMS,
  KRLS and ALD states (healthy and poisoned): ``finite`` exact, the rest
  within 1e-6 relative (XLA and PyTorch reduce in other orders); the
  thresholds equal; the same stats sequence raises the same events.
* Dispatch counters under the port's semantics: every op call is a live
  launch (``kernel.launches`` = the time blocks, ``kernel.traces`` never
  counts), with ``repro``'s bytes closed forms.
* The lockstep tier's spans: with nothing recording every span is the
  shared null context, and the outputs are the same bits untraced, under
  a tracer and under torch.profiler alone, whose trace nests
  ``lockstep.write`` > ``kernel.<op>_chunk`` and ``lockstep.read`` >
  ``kernel.bank_predict`` and shows ``lockstep.reset``, and whose spans
  the program totals by nesting path (``profiled_spans``); a host value bound
  for a device (meta stands for the card) is one ``host.wait`` span and
  one ``host.device_waits{site=...}``, a CPU one neither.
* The server: traced and probed equals untraced bit for bit (klms, krls);
  the ``observability()`` export has ``repro``'s keys; the read contract
  holds at 0.05.

The port runs on ``device="cpu"``; ``repro`` its XLA path.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rff import sample_rff as jax_sample_rff
from repro.features.base import as_trig as jax_as_trig
from repro.obs import probes as jprobes
from repro.obs import trace as jtrace
from repro.serve import api as japi
from repro_torch import convert
from repro_torch.core.klms import LMSState
from repro_torch.core.krls import RLSState
from repro_torch.core.krls_ald import ALDKRLSState
from repro_torch.kernels import ops
from repro_torch.obs import probes, telemetry
from repro_torch.obs import trace as ttrace
from repro_torch.serve import api

torch.set_num_threads(2)

TAP_REL = 1e-6
D_IN, D_FEAT = 3, 16
_JTF = jax_as_trig(jax_sample_rff(jax.random.PRNGKey(0), D_IN, D_FEAT, 1.0))
_TTF = convert.trig_features(*(np.asarray(a) for a in _JTF), device="cpu")


class FakeClock:
    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _traffic(tenants=3, n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, tenants)),
             rng.normal(size=D_IN).astype(np.float32), float(rng.normal()))
            for _ in range(n)]


def _drive(srv, traffic, read_every=5):
    for i, (t, x, y) in enumerate(traffic):
        if i % read_every == read_every - 1:
            srv.predict(t, x)
        else:
            srv.submit(t, x, y)
    srv.drain()


# -- the tracer --------------------------------------------------------------


def _record(mod, **kw):
    tr = mod.Tracer(clock=FakeClock(0.25), **kw)
    with mod.activate(tr):
        with mod.span("serve.submit", tenant=1):
            with mod.span("queue.flush", chunk=4) as sp:
                with mod.span("kernel.klms_chunk", shape=[2, 4, 3],
                              dtype="float32"):
                    pass
                sp.attrs["ticks"] = 5
            mod.instant("snapshot.publish", version=2, tick=5)
        mod.instant("probe.degraded", probe="finite", value=float("nan"))
        with mod.span("serve.predict", tenant=0):
            pass
    return tr


def test_tracer_exports_equal_repro():
    got, want = _record(ttrace), _record(jtrace)
    assert got.to_jsonl() == want.to_jsonl()
    # As JSON text: the NaN attribute is not equal to itself in a dict.
    assert json.dumps(got.to_chrome_trace()) == json.dumps(
        want.to_chrome_trace())
    assert got.summary() == want.summary()


@pytest.mark.parametrize("capacity", [0, 1, 4])
def test_tracer_ring_overflow_and_zero_capacity(capacity):
    if capacity == 0:
        for mod in (ttrace, jtrace):
            with pytest.raises(ValueError, match="capacity"):
                mod.Tracer(capacity=0)
        return
    tracers = [mod.Tracer(capacity=capacity, clock=FakeClock())
               for mod in (ttrace, jtrace)]
    for tr in tracers:
        for i in range(10):
            with tr.span(f"serve.op{i}"):
                pass
    got, want = tracers
    assert [s.name for s in got.spans()] == [s.name for s in want.spans()]
    assert got.dropped == want.dropped == 10 - capacity and got.truncated
    assert got.to_jsonl() == want.to_jsonl()
    assert got.to_chrome_trace() == want.to_chrome_trace()


def test_ambient_helpers_noop_without_a_tracer():
    assert ttrace.current_tracer() is None
    with ttrace.span("serve.submit") as sp:
        assert sp is None
    assert ttrace.instant("snapshot.publish") is None
    tr = ttrace.Tracer(clock=FakeClock(), jax_annotations=True)
    with ttrace.activate(None):
        assert ttrace.current_tracer() is None
    with ttrace.activate(tr):
        with ttrace.span("serve.submit"):  # through record_function
            ttrace.instant("snapshot.publish")
    assert {s.name for s in tr.spans()} == {"serve.submit",
                                            "snapshot.publish"}


def test_traced_server_chrome_trace_passes_the_validator(tmp_path):
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "check_bench_schema.py")
    spec = importlib.util.spec_from_file_location("check_bench_schema", path)
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    srv = api.make_server("klms", feature_map=_TTF, bank=3, chunk=4, mu=0.3,
                          trace=True, device="cpu")
    _drive(srv, _traffic(seed=2))
    out = tmp_path / "trace.json"
    srv.tracer.to_chrome_trace(str(out))
    assert checker.check_trace(str(out)) == []
    names = {s.name for s in srv.tracer.spans()}
    assert {"serve.submit", "serve.predict", "serve.drain", "queue.flush",
            "kernel.klms_chunk", "kernel.bank_predict",
            "snapshot.publish"} <= names


# -- the probes --------------------------------------------------------------


def _np_states(seed=0, poison=False):
    """KLMS, KRLS and ALD bank states as numpy arrays (B = 3)."""
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(3, 8)).astype(np.float32)
    pmat = rng.normal(size=(3, 8, 8)).astype(np.float32)
    pmat = pmat + np.swapaxes(pmat, -1, -2)
    pmat += 1e-3 * rng.normal(size=pmat.shape).astype(np.float32)
    ald_p = np.zeros((3, 6, 6), np.float32)
    ald_p[:, :3, :3] = pmat[:, :3, :3]  # an empty dictionary tail
    ald_p[2] = 0.0  # a slot with no dictionary at all
    step = np.arange(3, dtype=np.int32)
    if poison:
        theta[1, 2] = np.nan
        pmat[0, 1, 1] = np.inf
    return {
        "klms": (LMSState, dict(theta=theta, step=step)),
        "krls": (RLSState, dict(theta=theta, pmat=pmat, step=step)),
        "ald": (ALDKRLSState, dict(
            centers=rng.normal(size=(3, 6, 2)).astype(np.float32),
            alpha=theta[:, :6].copy(), kinv=ald_p * 0.5, pmat=ald_p,
            size=np.array([3, 3, 0], np.int32), step=step)),
    }


def _pair(cls, leaves):
    """The same state for the port (NamedTuple of tensors) and repro (a
    dict keyed by field, flattened in sorted order: the names, not the
    order, matter to the tap)."""
    port = cls(**{k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
    jax_state = {k: jnp.asarray(v) for k, v in leaves.items()}
    return port, jax_state


def _stats_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        if k == "finite":
            assert np.array_equal(g, w), k
        else:
            np.testing.assert_allclose(g, w, rtol=TAP_REL, atol=0, err_msg=k)


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("family", ["klms", "krls", "ald"])
def test_stats_tap_and_slot_stats_match_repro(family, poison):
    cls, leaves = _np_states(poison=poison)[family]
    port, jstate = _pair(cls, leaves)
    _stats_close({k: v.numpy() for k, v in probes.stats_tap(port).items()},
                 {k: np.asarray(v)
                  for k, v in jprobes.stats_tap(jstate).items()})
    _stats_close({k: v.numpy() for k, v in probes.slot_stats(port).items()},
                 {k: np.asarray(v)
                  for k, v in jprobes.slot_stats(jstate).items()})
    assert all(v.dtype == torch.float32 and v.ndim == 0
               for v in probes.stats_tap(port).values())


def test_default_thresholds_equal_repro():
    assert probes.DEFAULT_THRESHOLDS == jprobes.DEFAULT_THRESHOLDS


def test_monitor_events_equal_repro():
    seq = [({"finite": 1.0, "theta.norm_max": 3.0}, dict(tick=1)),
           ({"finite": 0.0, "theta.norm_max": 2e6, "pmat.asym_rel": 1e-4},
            dict(tick=7)),
           ({"pmat.asym_rel": 0.5, "pmat.cond_proxy": 1e13},
            dict(staleness=5, bf16_err=5e-4)),
           ({}, dict(staleness=1, bf16_err=2e-3, tick=9)),
           ({"ticks_lag": 2.0, "clock_skew": 1.0}, dict(tick=11))]
    overrides = {"staleness_ticks": 3, "bf16_read_error": ("max", 1e-3),
                 "clock_skew": 0.5}
    monitors = [mod.ProbeMonitor(thresholds=overrides, max_events=4)
                for mod in (probes, jprobes)]
    for stats, kw in seq:
        got, want = (m.update(stats, **kw) for m in monitors)
        assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    assert monitors[0].state() == monitors[1].state()


# -- dispatch telemetry ------------------------------------------------------


def test_dispatch_counts_every_call_as_a_live_launch():
    telemetry.reset()
    rng = np.random.default_rng(0)
    theta = torch.zeros(2, D_FEAT)
    xs = torch.from_numpy(rng.normal(size=(2, 10, D_IN)).astype(np.float32))
    ys = torch.from_numpy(rng.normal(size=(2, 10)).astype(np.float32))
    tr = ttrace.Tracer(clock=FakeClock())
    with ttrace.activate(tr):
        for _ in range(2):
            ops.rff_klms_bank_chunk(theta, xs, ys, _TTF.omega, _TTF.bias,
                                    0.2, chunk=4)
        ops.rff_klms_chunk_elements(xs[0], ys[0], _TTF.omega, _TTF.bias,
                                    0.2, chunk=4)
        ops.rff_bank_predict(theta, xs, _TTF.omega, _TTF.bias)
    reg = telemetry.registry()
    # T = 10 at chunk 4: three launches a call, the last a short block;
    # a second call launches again (no cached trace).
    assert reg.count("kernel.launches", op="klms_chunk") == 6
    assert reg.count("kernel.remainder_launches", op="klms_chunk") == 2
    assert reg.count("kernel.traces", op="klms_chunk") == 0
    assert reg.count("kernel.launches", op="klms_elements") == 1
    assert reg.count("kernel.launches", op="bank_predict") == 1
    bm = telemetry.klms_chunk_bytes(2, D_IN, D_FEAT, 4)
    assert reg.gauge("kernel.bytes_moved", op="klms_chunk") == (
        bm["launch_bytes"] * 3 + bm["stream_bytes_per_tick"] * 10)
    assert reg.gauge("kernel.bytes_moved", op="bank_predict") == (
        telemetry.predict_read_bytes(2, D_IN, D_FEAT, 10)["fused_bytes"])
    spans = [s for s in tr.spans() if s.name == "kernel.klms_chunk"]
    assert len(spans) == 2
    assert spans[0].attrs == {"launches": 3, "shape": [2, 10, D_IN],
                              "dfeat": D_FEAT, "dtype": "torch.float32",
                              "mode": "auto", "chunk": 4}


# -- the lockstep tier's spans and the host's waits ---------------------------

_LOCKSTEP_HP = {"klms": dict(mu=0.3), "krls": dict(lam=0.1, beta=0.999)}


def _lockstep_round(learner):
    """One write, read and reset of the lockstep tier (``mode="ref"``) on a
    fixed bank; returns every tensor it produced."""
    from repro_torch.core.bank import (bank_predict_block, klms_bank_init,
                                       krls_bank_init)

    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(4, 6, D_IN)).astype(np.float32))
    ys = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    mask = torch.from_numpy((rng.random((4, 6)) > 0.3).astype(np.float32))
    xq = torch.from_numpy(rng.normal(size=(4, 5, D_IN)).astype(np.float32))
    state = (klms_bank_init(_TTF, 4) if learner == "klms"
             else krls_bank_init(_TTF, 4, 0.1))
    step = api.make_chunk_step(learner, _TTF, mode="ref",
                               **_LOCKSTEP_HP[learner])
    state, out = step(state, xs, ys, mask)
    read = bank_predict_block(state, xq, _TTF, mode="ref")
    state = api.reset_slots(state, torch.tensor([1, 3]), learner=learner,
                            lam=0.1)
    return [*state, out.prediction, out.error, read]


@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_lockstep_spans_cost_nothing_and_change_no_bit(learner):
    """With no tracer and no profiler every span is the shared null
    context; the lockstep tier's outputs are the same bits untraced, under
    a tracer and under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    assert not ttrace.recording()
    assert ttrace.span("lockstep.write") is ttrace.span("kernel.klms_chunk")
    assert ttrace.host_wait("mu_column") is ttrace.span("host.wait")
    plain = _lockstep_round(learner)
    tr = ttrace.Tracer(clock=FakeClock())
    with ttrace.activate(tr):
        traced = _lockstep_round(learner)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _lockstep_round(learner)
    for got in (traced, profiled):
        assert all(torch.equal(a, b) for a, b in zip(plain, got))
    names = {s.name for s in tr.spans()}
    assert {"lockstep.write", "lockstep.read", "lockstep.reset"} <= names


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_profiler_records_the_lockstep_spans_without_a_tracer(learner,
                                                              tmp_path):
    """Under torch.profiler alone the program's spans are profiler ranges:
    ``lockstep.write`` holds ``kernel.<learner>_chunk``, ``lockstep.read``
    holds ``kernel.bank_predict``, and ``lockstep.reset`` is there."""
    from torch.profiler import ProfilerActivity, profile

    assert ttrace.current_tracer() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert ttrace.recording()
        _lockstep_round(learner)
    assert not ttrace.recording()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = _ranges(path)

    def inside(inner, outer):
        ins = [r for r in ranges if r[0] == inner]
        outs = [r for r in ranges if r[0] == outer]
        return len(ins) == 1 and len(outs) == 1 and (
            outs[0][1] <= ins[0][1] and ins[0][2] <= outs[0][2])

    assert inside(f"kernel.{learner}_chunk", "lockstep.write")
    assert inside("kernel.bank_predict", "lockstep.read")
    assert [r[0] for r in ranges].count("lockstep.reset") == 1


@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_profiled_spans_total_by_nesting_path(learner):
    """While the profiler records, every span adds its count and host time
    under its nesting path, with or without a tracer; with the profiler off
    nothing is added."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref

    ttrace.clear_profiled_spans()
    _lockstep_round(learner)
    with ttrace.activate(ttrace.Tracer(clock=FakeClock())):
        _lockstep_round(learner)
    assert ttrace.profiled_spans() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _lockstep_round(learner)
        with ttrace.activate(ttrace.Tracer(clock=FakeClock())):
            _lockstep_round(learner)
        with ttrace.span("lockstep.write"):
            ref.mu_column(0.5, torch.empty(4, device="meta"), 4)
    totals = ttrace.profiled_spans()
    write, chunk = ("lockstep.write",), ("lockstep.write",
                                         f"kernel.{learner}_chunk")
    assert totals[write][0] == 3 and totals[chunk][0] == 2
    assert totals[("lockstep.read", "kernel.bank_predict")][0] == 2
    assert totals[("lockstep.reset",)][0] == 2
    assert totals[("lockstep.write", "host.wait")][0] == 1
    assert all(n > 0 and s > 0 for n, s in totals.values())
    assert totals[write][1] > totals[chunk][1]
    ttrace.clear_profiled_spans()
    assert ttrace.profiled_spans() == {}


def _waits(site):
    return telemetry.registry().count("host.device_waits", site=site)


@pytest.mark.parametrize("column,site", [("mu", "mu_column"),
                                         ("beta", "beta_column")])
def test_a_host_value_bound_for_a_device_is_one_spanned_wait(column, site):
    """A Python step size (or forgetting factor) made into a column on a
    device (the meta device stands for the card) is one ``host.wait`` span
    and one ``host.device_waits{site=...}``; a CPU column, or a value
    already on the column's device, is neither."""
    from repro_torch.kernels import ref

    fn = ref.mu_column if column == "mu" else ref.beta_column
    meta = torch.empty(4, device="meta")
    tr = ttrace.Tracer(clock=FakeClock())
    before = _waits(site)
    with ttrace.activate(tr):
        got = fn(0.5, meta, 4)
    assert got.device.type == "meta" and got.shape == (4,)
    assert _waits(site) == before + 1
    waits = [s for s in tr.spans() if s.name == "host.wait"]
    assert len(waits) == 1 and waits[0].attrs == {"site": site}
    tr = ttrace.Tracer(clock=FakeClock())
    with ttrace.activate(tr):
        fn(0.5, torch.empty(4), 4)
        fn(torch.full((4,), 0.5, device="meta"), meta, 4)
        fn(torch.tensor(0.5, device="meta"), meta, 4)
    assert _waits(site) == before + 1
    assert not [s for s in tr.spans() if s.name == "host.wait"]


@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_reset_slots_spans_its_host_values(learner):
    """``reset_slots`` on a device (meta stands for the card) waits once a
    leaf for the 0 it writes and once for slots given from the host; on
    the CPU it waits for nothing. Its ``lockstep.reset`` span gives the
    rows and the bytes cloned."""
    from repro_torch.core.bank import klms_bank_init, krls_bank_init

    state = (klms_bank_init(_TTF, 4) if learner == "klms"
             else krls_bank_init(_TTF, 4, 0.1))
    meta = type(state)(*(a.to("meta") for a in state))

    def counts():
        return (_waits("reset_slots.index"), _waits("reset_slots.fill"))

    index0, fill0 = counts()
    tr = ttrace.Tracer(clock=FakeClock())
    with ttrace.activate(tr):
        api.reset_slots(meta, [1, 2], lam=0.1)
        api.reset_slots(meta, torch.tensor([0], device="meta"), lam=0.1)
        api.reset_slots(state, [1, 2], lam=0.1)
    assert counts() == (index0 + 1, fill0 + 2 * len(state))
    resets = [s.attrs for s in tr.spans() if s.name == "lockstep.reset"]
    nbytes = sum(a.numel() * a.element_size() for a in state)
    assert resets == [{"learner": learner, "rows": 2, "bytes_cloned": nbytes},
                      {"learner": learner, "rows": 1, "bytes_cloned": nbytes},
                      {"learner": learner, "rows": 2, "bytes_cloned": nbytes}]
    waits = [s.attrs["site"] for s in tr.spans() if s.name == "host.wait"]
    assert waits == (["reset_slots.index"] + ["reset_slots.fill"]
                     * (2 * len(state)))


def test_bytes_closed_forms_equal_repro():
    from repro.obs import telemetry as jtel

    for args in ((1024, 128, 2048, 16), (1024, 5, 300, 1), (3, 7, 11, 5)):
        assert telemetry.klms_chunk_bytes(*args) == jtel.klms_chunk_bytes(
            *args)
        assert telemetry.krls_chunk_bytes(*args) == jtel.krls_chunk_bytes(
            *args)
        assert telemetry.predict_read_bytes(*args) == (
            jtel.predict_read_bytes(*args))


# -- the server --------------------------------------------------------------


@pytest.mark.parametrize("learner,hp", [
    ("klms", dict(mu=0.3)), ("krls", dict(beta=0.999, lam=0.1))])
def test_traced_probed_server_is_bitwise_untraced(learner, hp):
    traffic = _traffic(seed=4)
    plain = api.make_server(learner, feature_map=_TTF, bank=3, chunk=4,
                            device="cpu", **hp)
    traced = api.make_server(learner, feature_map=_TTF, bank=3, chunk=4,
                             device="cpu", trace=True, probe=True,
                             recovery=True, **hp)
    _drive(plain, traffic)
    _drive(traced, traffic)
    assert all(torch.equal(a, b)
               for a, b in zip(plain.queue.state, traced.queue.state))
    xq = np.stack([x for _, x, _ in traffic[:4]])
    assert torch.equal(plain.predict(1, xq), traced.predict(1, xq))
    by_name = traced.tracer.summary()["by_name"]
    for prefix in ("serve.", "queue.", "snapshot.", "kernel."):
        assert any(n.startswith(prefix) for n in by_name), prefix
    assert traced.probe.updates > 0 and traced.probe.healthy()
    assert traced.probe.last_stats["finite"] == 1.0
    assert ("pmat.asym_rel" in traced.probe.last_stats) == (learner == "krls")


def test_probed_server_stats_match_repro():
    """The tap's readout after the same stream, through both servers."""
    traffic = _traffic(seed=6)
    hp = dict(beta=0.999, lam=0.1)
    tsrv = api.make_server("krls", feature_map=_TTF, bank=3, chunk=4,
                           device="cpu", probe=True, **hp)
    jsrv = japi.make_server("krls", feature_map=_JTF, bank=3, chunk=4,
                            mode="xla", probe=True, **hp)
    for srv in (tsrv, jsrv):
        _drive(srv, traffic)
    got, want = tsrv.probe.last_stats, jsrv.probe.last_stats
    assert set(got) == set(want)
    for k in want:
        # The states themselves differ by the served-stream bound.
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_observability_schema_equals_repro_and_read_contract():
    kw = dict(bank=2, chunk=4, mu=0.3, trace=True, probe=True)
    tsrv = api.make_server("klms", feature_map=_TTF, device="cpu", **kw)
    jsrv = japi.make_server("klms", feature_map=_JTF, mode="xla", **kw)
    xq = np.ones((2, 3, D_IN), np.float32)
    for srv in (tsrv, jsrv):
        _drive(srv, _traffic(tenants=2, n=16, seed=7))
        err = srv.check_read_contract(xq)
        assert isinstance(err, float) and 0.0 <= err < 0.05
        assert srv.probe.last_stats["bf16_read_error"] == err
    got, want = tsrv.observability(), jsrv.observability()
    assert set(got) == set(want) == {"metrics", "dispatch", "probes",
                                     "trace"}
    for key in got:
        assert set(got[key]) == set(want[key]), key
    assert set(got["metrics"]["counters"]) == set(
        want["metrics"]["counters"])
    assert set(got["probes"]["last"]) == set(want["probes"]["last"])
    assert any(k.startswith("dispatch.launches")
               for k in got["dispatch"]["counters"])
    json.dumps(got)
    bare = api.make_server("klms", feature_map=_TTF, bank=2, device="cpu")
    assert bare.tracer is None and bare.probe is None
    assert bare.observability()["probes"] is None
    assert bare.observability()["trace"] is None


def test_rejected_arrival_leaves_the_ledger_alone():
    """An arrival the server refuses (x of the wrong shape) is neither
    logged nor counted as queued, so it cannot raise ticks_lag."""
    srv = api.make_server("klms", feature_map=_TTF, bank=2, chunk=4, mu=0.3,
                          probe=True, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        srv.submit(0, np.zeros(D_IN + 1, np.float32), 1.0)
    srv.submit(1, np.zeros(D_IN, np.float32), 1.0)
    srv.drain()
    assert srv._slot_lags() == [0, 0] and srv.probe.healthy()
