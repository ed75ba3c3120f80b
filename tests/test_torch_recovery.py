"""The port's recovery tier (serve/recovery.py, obs/faults.py) held against
``repro`` on the CPU.

* The write-ahead log is ``repro``'s format byte for byte: the same
  arrivals (NaN and Inf among them) give the same file, and both read a
  torn tail the same way.
* Checkpoints keep ``repro``'s payload: a generation that ``repro`` wrote
  restores into the port's server with every leaf exact, and the two then
  serve the same stream within the served-stream bound of
  tests/test_torch_serve.py (1e-4); the port's own round trip, the corrupt
  newest generation, a config mismatch and GC as in tests/test_recovery.py.
* The fault matrix of tests/test_chaos.py (four kinds x five families,
  plus ``clock_skew``): detection, quarantine, the ladder's history as
  ``_expected_outcome`` gives it, and the never-faulted control after the
  equivalent operator action, bit for bit (reset, rebuild) or within
  ``_RESYM_TOL`` (resymmetrize); on one family a kind, the history equals
  ``repro``'s. A fault replaces the live state with a copy, so the
  published replica keeps the tenant's healthy row.
* Kill at a flush, restore and WAL replay equal the never-killed server
  bit for bit (klms, krls, ald at cuts 7, 23 and 41).

The port runs on ``device="cpu"`` (every kernel's plain version); ``repro``
runs its XLA path.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.rff import sample_rff as jax_sample_rff
from repro.features.base import as_trig as jax_as_trig
from repro.obs.faults import Fault as JaxFault
from repro.obs.faults import FaultInjector as JaxFaultInjector
from repro.obs.faults import FaultPlan as JaxFaultPlan
from repro.serve import api as japi
from repro.serve.recovery import DurableLog as JaxDurableLog
from repro_torch import convert
from repro_torch.obs.faults import Fault, FaultInjector, FaultPlan
from repro_torch.serve import (
    DurableLog,
    RecoveryPolicy,
    make_server,
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(2)

STREAM_TOL = 1e-4
_RESYM_TOL = 5e-2  # tests/test_chaos.py
_TENANT = 1
FAMILIES = ["klms", "nklms", "krls", "qklms", "ald"]
_KW = {
    "klms": dict(mu=0.3),
    "nklms": dict(mu=0.3),
    "krls": dict(lam=0.1, beta=0.99),
    "qklms": dict(sigma=1.0, mu=0.3, quant_eps=0.1, capacity=32),
    "ald": dict(sigma=1.0, nu=5e-4, capacity=32),
}
_JTF = jax_as_trig(jax_sample_rff(jax.random.PRNGKey(0), 3, 32, 1.0))
_TTF = convert.trig_features(*(np.asarray(a) for a in _JTF), device="cpu")


def _make(learner, **kw):
    return make_server(learner, feature_map=_TTF, bank=4, chunk=4,
                       policy="lru", log_capacity=512, device="cpu",
                       **_KW[learner], **kw)


def _jmake(learner, **kw):
    return japi.make_server(learner, feature_map=_JTF, bank=4, chunk=4,
                            policy="lru", log_capacity=512, mode="xla",
                            **_KW[learner], **kw)


def _traffic(seed, n, tenants=3):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, tenants)),
             rng.standard_normal(3).astype(np.float32),
             float(rng.standard_normal())) for _ in range(n)]


def _leaves_equal(a, b) -> bool:
    return all(np.array_equal(convert.to_numpy(x), np.asarray(y),
                              equal_nan=True) for x, y in zip(a, b))


# -- the write-ahead log -----------------------------------------------------


def test_wal_bytes_equal_repro_and_torn_tail(tmp_path):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((8, 3)).astype(np.float32)
    xs[3, 1] = np.nan
    xs[6, 0] = -np.inf
    ys = rng.standard_normal(8).astype(np.float32)
    ys[5] = np.inf
    paths = {"port": tmp_path / "port.jsonl", "repro": tmp_path / "repro.jsonl"}
    logs = {"port": DurableLog(paths["port"]),
            "repro": JaxDurableLog(paths["repro"])}
    for i in range(8):
        # The port's server hands the WAL tensors too: through numpy.
        x = torch.from_numpy(xs[i]) if i % 2 else xs[i]
        assert logs["port"].append(i % 3, x, ys[i]) == i
        assert logs["repro"].append(i % 3, xs[i], ys[i]) == i
    for log in logs.values():
        log.close()
    assert paths["port"].read_bytes() == paths["repro"].read_bytes()
    back = DurableLog(paths["port"])
    for i, e in enumerate(back.entries()):
        assert np.array_equal(np.asarray(e["x"], np.float32), xs[i],
                              equal_nan=True)
        assert np.array_equal(np.float32(e["y"]), ys[i], equal_nan=True)
    back.close()
    for path in paths.values():  # a crash mid-append
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"s": 8, "t": 0, "x": [0.0')
    resumed = {"port": DurableLog(paths["port"]),
               "repro": JaxDurableLog(paths["repro"])}
    for key, log in resumed.items():
        assert log.seq == 7
        assert log.append(1, np.ones(3, np.float32), 9.0) == 8
        assert log.entries(after=7)[0]["t"] == 1
        log.close()
    assert paths["port"].read_bytes() == paths["repro"].read_bytes()


# -- checkpoints -------------------------------------------------------------


@pytest.mark.parametrize("learner", FAMILIES)
def test_checkpoint_round_trip_bitwise(tmp_path, learner):
    a = _make(learner)
    for t, x, y in _traffic(1, 30):
        a.submit(t, x, y)
    a.flush()  # a backlog stays pending
    path = a.checkpoint(tmp_path / "ckpt")
    assert os.path.basename(path) == "gen_00000000.ckpt"
    b = _make(learner)
    info = restore_checkpoint(b, tmp_path / "ckpt")
    assert info["generation"] == 0 and info["replayed"] == 0
    assert all(torch.equal(x, y) for x, y in zip(a.queue.state, b.queue.state))
    assert all(torch.equal(x, y)
               for x, y in zip(a.snapshot.state, b.snapshot.state))
    assert a.snapshot.version == b.snapshot.version
    assert a.queue.backlog() == b.queue.backlog() != [0] * 4
    assert (a.queue.ticks_served, a.queue.flushes) == (
        b.queue.ticks_served, b.queue.flushes)
    assert a.policy.state_dict() == b.policy.state_dict()
    assert a._expected == b._expected
    for t in a.log.tenants():
        assert a.log.dropped(t) == b.log.dropped(t)
        for u, v in zip(a.log.arrays(t), b.log.arrays(t)):
            assert np.array_equal(u, v)
    for t, x, y in _traffic(2, 20):
        a.submit(t, x, y)
        b.submit(t, x, y)
    a.drain()
    b.drain()
    assert all(torch.equal(x, y) for x, y in zip(a.queue.state, b.queue.state))


@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_repro_checkpoint_restores_into_port(tmp_path, learner):
    """A generation repro wrote: every leaf exact in the port's server,
    then the same stream served by both within STREAM_TOL."""
    jsrv = _jmake(learner)
    for t, x, y in _traffic(3, 30):
        jsrv.submit(t, x, y)
    jsrv.flush()
    jsrv.checkpoint(tmp_path / "ckpt")
    tsrv = _make(learner)
    info = restore_checkpoint(tsrv, tmp_path / "ckpt")
    assert info["generation"] == 0
    assert _leaves_equal(tsrv.queue.state, jsrv.queue.state)
    assert _leaves_equal(tsrv.snapshot.state, jsrv.snapshot.state)
    assert tsrv.queue.backlog() == jsrv.queue.backlog()
    assert tsrv.policy.state_dict() == jsrv.policy.state_dict()
    assert tsrv._expected == jsrv._expected
    for t, x, y in _traffic(4, 24):
        jsrv.submit(t, x, y)
        tsrv.submit(t, x, y)
    jsrv.drain()
    tsrv.drain()
    for got, want in zip(tsrv.queue.state, jsrv.queue.state):
        np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                                   atol=STREAM_TOL, rtol=STREAM_TOL)
    xq = np.stack([x for _, x, _ in _traffic(5, 6)])
    for tenant in range(3):
        np.testing.assert_allclose(
            convert.to_numpy(tsrv.predict(tenant, xq)),
            np.asarray(jsrv.predict(tenant, xq)),
            atol=STREAM_TOL, rtol=STREAM_TOL)


def test_checkpoints_cross_both_ways_with_an_rff_draw(tmp_path):
    """repro serves a paper RFF draw as (omega, bias); the port serves its
    trig form. A generation written by either restores into the other
    with every leaf exact."""
    rff = jax_sample_rff(jax.random.PRNGKey(1), 3, 32, 1.0)
    ttf = convert.trig_features(np.asarray(rff.omega), np.asarray(rff.bias),
                                device="cpu")
    kw = dict(bank=4, chunk=4, policy="lru", log_capacity=64, mu=0.3)
    jsrv = japi.make_server("klms", feature_map=rff, mode="xla", **kw)
    tsrv = make_server("klms", feature_map=ttf, device="cpu", **kw)
    for srv in (jsrv, tsrv):
        for t, x, y in _traffic(7, 21):
            srv.submit(t, x, y)
        srv.flush()
    jsrv.checkpoint(tmp_path / "from_repro")
    tsrv.checkpoint(tmp_path / "from_port")
    tback = make_server("klms", feature_map=ttf, device="cpu", **kw)
    restore_checkpoint(tback, tmp_path / "from_repro")
    assert _leaves_equal(tback.queue.state, jsrv.queue.state)
    from repro.serve.recovery import restore_checkpoint as jrestore

    jback = japi.make_server("klms", feature_map=_JTF, mode="xla", **kw)
    with pytest.raises(ValueError, match="feature map"):
        jrestore(jback, tmp_path / "from_port")  # not the same map
    jback = japi.make_server("klms", feature_map=jax_as_trig(rff),
                             mode="xla", **kw)
    jrestore(jback, tmp_path / "from_port")
    assert _leaves_equal(tsrv.queue.state, jback.queue.state)
    assert jback.policy.state_dict() == tsrv.policy.state_dict()
    assert jback.queue.backlog() == tsrv.queue.backlog()


def test_checkpoint_keeps_ring_overflow_flag(tmp_path):
    args = dict(feature_map=_TTF, bank=2, chunk=4, policy="lru",
                log_capacity=4, mu=0.3, device="cpu")
    a = make_server("klms", **args)
    for _, x, y in _traffic(3, 12, tenants=1):
        a.submit(0, x, y)
    a.drain()
    assert not a.log.complete(0)
    a.checkpoint(tmp_path / "ckpt")
    b = make_server("klms", **args)
    restore_checkpoint(b, tmp_path / "ckpt")
    assert not b.log.complete(0) and b.log.dropped(0) == a.log.dropped(0)


def test_restore_skips_corrupt_newest_generation(tmp_path):
    args = dict(feature_map=_TTF, bank=2, chunk=4, mu=0.3, policy="lru",
                log_capacity=16, device="cpu")
    a = make_server("klms", **args)
    for t, x, y in _traffic(4, 10):
        a.submit(t % 2, x, y)
    a.drain()
    ckdir = tmp_path / "ckpt"
    a.checkpoint(ckdir)
    good = [t.clone() for t in a.queue.state]
    for t, x, y in _traffic(5, 6):
        a.submit(t % 2, x, y)
    a.drain()
    newest = a.checkpoint(ckdir)
    with open(newest, "wb") as fh:
        fh.write(b"\x80garbage")
    b = make_server("klms", **args)
    assert restore_checkpoint(b, ckdir)["generation"] == 0
    assert all(torch.equal(x, y) for x, y in zip(b.queue.state, good))
    # A payload that references code is refused as unloadable, too.
    import pickle

    with open(newest, "wb") as fh:
        fh.write(pickle.dumps({"format": os.system}))
    c = make_server("klms", **args)
    assert restore_checkpoint(c, ckdir)["generation"] == 0


def test_restore_raises_on_config_mismatch(tmp_path):
    a = make_server("klms", feature_map=_TTF, bank=2, chunk=4, mu=0.3,
                    policy="lru", device="cpu")
    a.checkpoint(tmp_path / "ckpt")
    b = make_server("klms", feature_map=_TTF, bank=2, chunk=4, mu=0.7,
                    policy="lru", device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(b, tmp_path / "ckpt")


def test_checkpoint_gc_keeps_newest_generations(tmp_path):
    a = make_server("klms", feature_map=_TTF, bank=2, chunk=4, mu=0.3,
                    policy="lru", device="cpu")
    ckdir = tmp_path / "ckpt"
    for _ in range(5):
        save_checkpoint(a, ckdir, keep=2)
    names = sorted(n for n in os.listdir(ckdir) if n.endswith(".ckpt"))
    assert names == ["gen_00000003.ckpt", "gen_00000004.ckpt"]
    assert (ckdir / "LATEST").read_text().strip() == "gen_00000004.ckpt"


def test_wal_replay_is_idempotent_across_restores(tmp_path):
    args = dict(feature_map=_TTF, bank=4, chunk=4, mu=0.3, policy="lru",
                log_capacity=64, size_watermark=4, device="cpu")
    wal_path = str(tmp_path / "wal.jsonl")
    a = make_server("klms", wal=wal_path, **args)
    traffic = _traffic(6, 40)
    for t, x, y in traffic[:25]:
        a.submit(t, x, y)
    a.checkpoint(tmp_path / "ckpt")
    for t, x, y in traffic[25:]:
        a.submit(t, x, y)
    a.drain()
    size = os.path.getsize(wal_path)
    b = make_server("klms", wal=wal_path, **args)
    assert restore_checkpoint(b, tmp_path / "ckpt")["replayed"] == 15
    assert os.path.getsize(wal_path) == size
    b.drain()
    c = make_server("klms", wal=wal_path, **args)
    restore_checkpoint(c, tmp_path / "ckpt")
    c.drain()
    for x, y, z in zip(a.queue.state, b.queue.state, c.queue.state):
        assert torch.equal(x, y) and torch.equal(y, z)


# -- the fault matrix --------------------------------------------------------


def _expected_outcome(kind, learner):
    """tests/test_chaos.py: (probe that must fire, the ladder's history)."""
    if kind == "drop_flush":
        return "ticks_lag", [("rebuild", True)]
    if kind == "log_corrupt":
        return "finite", [("rebuild", None), ("reset", True)]
    if kind == "asym_pmat" and learner == "krls":
        return "pmat.asym_rel", [("resymmetrize", True)]
    return "finite", [("rebuild", True)]


def _inject(srv, kind, mid, injector=FaultInjector, plan=FaultPlan,
            fault=Fault):
    inj = injector(srv, plan([fault(kind, tenant=_TENANT, at_flush=0)]))
    inj.attach()
    for t, x, y in mid:
        srv.submit(t, x, y)
    srv.flush()
    srv.drain()
    inj.detach()
    return inj


def _phases(kind):
    traffic = _traffic(3, 60)
    warm, mid, tail = traffic[:30], traffic[30:42], traffic[42:]
    if kind != "drop_flush":
        # A trained row washes the poison out: fault a masked slot.
        mid = [a for a in mid if a[0] != _TENANT]
    return warm, mid, tail


@pytest.mark.parametrize("learner", FAMILIES)
@pytest.mark.parametrize(
    "kind", ["nan_state", "asym_pmat", "log_corrupt", "drop_flush"])
def test_fault_matrix_detect_quarantine_repair(kind, learner):
    srv = _make(learner, recovery=True)
    ctrl = _make(learner, probe=True)
    warm, mid, tail = _phases(kind)
    for s in (srv, ctrl):
        for t, x, y in warm:
            s.submit(t, x, y)
        s.drain()
    assert srv.probe.total_events == 0
    inj = _inject(srv, kind, mid)
    for t, x, y in mid:
        ctrl.submit(t, x, y)
    ctrl.flush()
    ctrl.drain()
    assert inj.applied and inj.applied[0]["flush"] == 0
    probe_name, ladder = _expected_outcome(kind, learner)
    at_detect = srv.probe.total_events
    assert probe_name in {ev.probe for ev in srv.probe.events}
    assert [(h["action"], h.get("verified"))
            for h in srv.recovery.history] == ladder
    assert srv.recovery.quarantined == frozenset()
    counters = srv.metrics.snapshot()["counters"]
    assert counters["recovery.quarantines"] == 1
    assert counters["recovery.releases"] == 1
    assert counters[f"recovery.repairs{{action={ladder[-1][0]}}}"] == 1
    final = ladder[-1][0]
    if final == "reset":
        ctrl.reset_tenant(_TENANT)
    elif final == "rebuild":
        ctrl.evict(_TENANT)
        ctrl.readmit(_TENANT)
    for t, x, y in tail:
        srv.submit(t, x, y)
        ctrl.submit(t, x, y)
    srv.drain()
    ctrl.drain()
    assert srv.probe.total_events == at_detect
    assert all(bool(torch.isfinite(a).all()) for a in srv.queue.state)
    assert all(lag <= 0 for lag in srv._slot_lags())
    if final == "resymmetrize":
        p = srv.queue.state.pmat[srv.resident[_TENANT]]
        assert float((p - p.T).abs().max()) <= 1e-5 * float(p.abs().max())
        xq = np.asarray(_traffic(9, 8)[0][1])[None].repeat(8, axis=0)
        a = convert.to_numpy(srv.predict(_TENANT, xq))
        b = convert.to_numpy(ctrl.predict(_TENANT, xq))
        assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-6) < _RESYM_TOL
    else:
        assert all(torch.equal(a, b) for a, b in
                   zip(srv.queue.state, ctrl.queue.state))
        assert srv._expected == ctrl._expected


@pytest.mark.parametrize("kind,learner", [
    ("nan_state", "klms"), ("asym_pmat", "krls"),
    ("log_corrupt", "nklms"), ("drop_flush", "ald")])
def test_ladder_history_equals_repro(kind, learner):
    """The same fault on the same stream: the same events, quarantine and
    ladder history (and counters) in both packages."""
    warm, mid, _ = _phases(kind)
    histories, events, counters = [], [], []
    for make, inj_kw in ((_make, {}),
                         (_jmake, dict(injector=JaxFaultInjector,
                                       plan=JaxFaultPlan, fault=JaxFault))):
        srv = make(learner, recovery=True)
        for t, x, y in warm:
            srv.submit(t, x, y)
        srv.drain()
        _inject(srv, kind, mid, **inj_kw)
        histories.append(srv.recovery.history)
        events.append([(ev.probe, ev.direction, ev.tick)
                       for ev in srv.probe.events])
        counters.append({k: v for k, v in
                         srv.metrics.snapshot()["counters"].items()
                         if k.startswith(("recovery.", "probe."))})
    assert histories[0] == histories[1]
    assert events[0] == events[1]
    assert counters[0] == counters[1]


@pytest.mark.parametrize("kind", ["nan_state", "asym_pmat", "log_corrupt"])
def test_fault_leaves_published_replica_unchanged(kind):
    """A fault writes into a fresh copy of the live state: the published
    replica (the quarantine's last healthy rows) is untouched."""
    srv = _make("krls", probe=True)
    for t, x, y in _traffic(3, 30):
        srv.submit(t, x, y)
    srv.drain()
    snap = srv.snapshot.state
    before = [a.clone() for a in snap]
    live = srv.queue.state
    inj = FaultInjector(srv, FaultPlan([]))
    inj._apply(Fault(kind, tenant=_TENANT, at_flush=0))
    assert srv.snapshot.state is snap
    assert all(torch.equal(a, b) for a, b in zip(snap, before))
    assert srv.queue.state is not live
    assert all(torch.equal(a, b) for a, b in zip(live, before))
    assert not all(np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
                   for a, b in zip(srv.queue.state, before))


def test_quarantined_reads_serve_the_healthy_row(monkeypatch):
    """While quarantined, a tenant's reads are predict_row of its last
    healthy row (one read at B = 1) and its writes are logged, not
    queued."""
    from repro_torch.serve.snapshot import predict_row

    srv = _make("klms", recovery=True)
    for t, x, y in _traffic(8, 30):
        srv.submit(t, x, y)
    srv.drain()
    slot = srv.resident[_TENANT]
    healthy = srv.snapshot.state.theta[slot].clone()
    rec = srv.recovery
    monkeypatch.setattr(rec, "_repair_due", lambda: None)
    srv.queue.state = srv.queue.state._replace(
        theta=srv.queue.state.theta.clone().index_fill_(
            0, torch.tensor([slot]), float("nan")))
    srv.submit(0, np.zeros(3, np.float32), 0.0)
    srv.drain()
    assert _TENANT in rec.quarantined
    xq = np.ones((2, 3), np.float32)
    pred = srv.predict(_TENANT, xq)
    assert torch.equal(pred, predict_row(healthy, xq, _TTF))
    assert bool(torch.isfinite(pred).all())
    n = srv.log.size(_TENANT)
    srv.submit(_TENANT, xq[0], 1.0)
    assert srv.log.size(_TENANT) == n + 1
    assert srv.queue.backlog()[slot] == 0
    counters = srv.metrics.snapshot()["counters"]
    assert counters["recovery.deferred"] == 1
    assert counters["read.quarantined"] == 1


def test_repair_error_propagates():
    """A repair that raises (a kernel's build or launch error, say) is not
    a failed rung: the error reaches the caller, nothing falls to reset."""
    srv = _make("klms", recovery=True)
    for t, x, y in _traffic(8, 30):
        srv.submit(t, x, y)
    srv.drain()

    def broken(*args):
        raise RuntimeError("kernel launch failed")

    srv.snapshot_server._rebuild_fn = broken
    slot = srv.resident[_TENANT]
    srv.queue.state = srv.queue.state._replace(
        theta=srv.queue.state.theta.clone().index_fill_(
            0, torch.tensor([slot]), float("nan")))
    srv.submit(0, np.zeros(3, np.float32), 0.0)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        srv.drain()
    assert not any(h["action"] == "reset" for h in srv.recovery.history)


def test_clock_skew_is_detected_and_reclocked():
    import time

    srv = _make("klms", probe={"clock_skew": 0.25},
                recovery={"reference_clock": time.monotonic})
    traffic = _traffic(4, 50)
    for t, x, y in traffic[:30]:
        srv.submit(t, x, y)
    srv.drain()
    assert srv.recovery.measure_skew() < 0.25
    inj = FaultInjector(srv, FaultPlan(
        [Fault("clock_skew", tenant=0, at_flush=0, magnitude=2.0)])).attach()
    for t, x, y in traffic[30:40]:
        srv.submit(t, x, y)
    srv.flush()
    srv.drain()
    inj.detach()
    assert srv.probe.total_events == 1
    assert srv.probe.events[0].probe == "clock_skew"
    assert srv.recovery.history == [{"event": "clock_skew",
                                     "action": "reclock",
                                     "skew": pytest.approx(2.0, abs=0.05)}]
    assert srv.recovery.quarantined == frozenset()
    assert srv.metrics.snapshot()["counters"][
        "recovery.repairs{action=reclock}"] == 1
    assert srv.recovery.measure_skew() < 0.25
    before = srv.probe.total_events
    for t, x, y in traffic[40:]:
        srv.submit(t, x, y)
    srv.drain()
    assert srv.probe.total_events == before


def test_repeated_failures_back_off_then_give_up(monkeypatch):
    fake = [0.0]
    srv = _make("klms", recovery={"max_retries": 2, "backoff_base": 10.0,
                                  "clock": lambda: fake[0]})
    for t, x, y in _traffic(8, 30):
        srv.submit(t, x, y)
    srv.drain()
    rec = srv.recovery
    monkeypatch.setattr(rec, "_verify", lambda ep: False)
    slot = srv.resident[_TENANT]
    srv.queue.state = srv.queue.state._replace(
        theta=srv.queue.state.theta.clone().index_fill_(
            0, torch.tensor([slot]), float("nan")))
    srv.submit(0, np.zeros(3, np.float32), 0.0)
    srv.drain()
    ep = rec._episodes[_TENANT]
    assert ep.attempts == 1 and ep.backoff_until == 20.0
    n = len(rec.history)
    srv.submit(0, np.zeros(3, np.float32), 0.0)
    srv.drain()
    assert len(rec.history) == n
    fake[0] = 100.0
    rec.process()
    fake[0] = 1000.0
    rec.process()
    assert ep.gave_up and _TENANT in rec.quarantined
    counters = srv.metrics.snapshot()["counters"]
    assert counters["recovery.gave_up"] == 1
    assert "recovery.releases" not in counters
    assert bool(torch.isfinite(srv.queue.state.theta).all())


def test_recovery_requires_probe_and_single_bind():
    with pytest.raises(ValueError, match="probe"):
        RecoveryPolicy().bind(make_server("klms", feature_map=_TTF, bank=2,
                                          device="cpu"))
    srv = make_server("klms", feature_map=_TTF, bank=2, device="cpu",
                      recovery=True)
    assert srv.probe is not None
    with pytest.raises(RuntimeError, match="bound"):
        srv.recovery.bind(srv)


# -- kill at a flush ---------------------------------------------------------


@pytest.mark.parametrize("learner", ["klms", "krls", "ald"])
@pytest.mark.parametrize("cut", [7, 23, 41])
def test_kill_at_flush_restore_equals_never_killed(tmp_path, learner, cut):
    args = dict(feature_map=_TTF, bank=4, chunk=4, policy="lru",
                log_capacity=512, size_watermark=4, device="cpu",
                **_KW[learner])
    wal_path = str(tmp_path / "wal.jsonl")
    traffic = _traffic(5, 48)
    orig = make_server(learner, wal=wal_path, **args)
    for t, x, y in traffic[:cut]:
        orig.submit(t, x, y)
    orig.checkpoint(tmp_path / "ckpt")
    for t, x, y in traffic[cut:]:
        orig.submit(t, x, y)
    orig.drain()
    restored = make_server(learner, wal=wal_path, **args)
    info = restore_checkpoint(restored, tmp_path / "ckpt")
    assert info["replayed"] == len(traffic) - cut
    restored.drain()
    assert all(torch.equal(a, b) for a, b in
               zip(orig.queue.state, restored.queue.state))
    assert all(torch.equal(a, b) for a, b in
               zip(orig.snapshot.state, restored.snapshot.state))
    assert orig.policy.state_dict() == restored.policy.state_dict()
    assert orig._expected == restored._expected
    xq = np.stack([x for _, x, _ in traffic[:6]])
    for tenant in range(3):
        assert torch.equal(orig.predict(tenant, xq),
                           restored.predict(tenant, xq))
