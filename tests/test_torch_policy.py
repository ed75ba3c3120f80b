"""The port's slot policy and policy-mode server held against ``repro`` on
the CPU.

``SlotPolicy`` is host bookkeeping, so on the same sequence of touches,
admissions, releases and moves its decisions, residency, victims, size
suggestions and exported state must equal ``repro``'s exactly, for every
scorer. The policy server (``make_server(policy=...)``) takes the same
Zipf stream of writes and reads in both packages (made with
``np.random.default_rng``; the feature map sampled by ``repro`` and
carried over with ``repro_torch.convert``): every decision, so every
counter and the resident map, must be equal, and the bank states within
the served-stream bound of tests/test_torch_serve.py (1e-4, abs + rel:
XLA and PyTorch round the projection, the reductions and the replay's
products differently, and each tick carries its difference on). The port
runs on ``device="cpu"`` (every kernel's plain version), ``repro`` its
XLA path (``mode="xla"``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.features.base import as_trig as jax_as_trig
from repro.features.random import rff_map as jax_rff_map
from repro.serve import api as japi
from repro.serve.policy import SlotPolicy as JaxSlotPolicy
from repro_torch import convert
from repro_torch.core.bank import tenant_row
from repro_torch.serve import SlotPolicy, api

torch.set_num_threads(2)

STREAM_TOL = 1e-4
D_IN, D_FEAT, BANK, TENANTS = 3, 24, 4, 16


def _maps(seed=0, d=D_IN, dfeat=D_FEAT, sigma=1.5):
    jtf = jax_as_trig(jax_rff_map(jax.random.PRNGKey(seed), d, dfeat, sigma))
    ttf = convert.trig_features(*(np.asarray(a) for a in jtf), device="cpu")
    return jtf, ttf


def _zipf_requests(seed, n, tenants=TENANTS, alpha=0.9, read_every=4):
    """zipf_bench's stream: tenant ids with pmf 1/rank^alpha, a read every
    ``read_every`` requests."""
    rng = np.random.default_rng(seed)
    probs = np.arange(1, tenants + 1, dtype=np.float64) ** -alpha
    ids = rng.choice(tenants, size=n, p=probs / probs.sum())
    xs = rng.normal(size=(n, D_IN)).astype(np.float32)
    ys = (np.sin(xs[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return [("read" if i % read_every == read_every - 1 else "write",
             int(ids[i]), xs[i], float(ys[i])) for i in range(n)]


def _serve(srv, requests):
    reads = []
    for kind, tenant, x, y in requests:
        if kind == "read":
            reads.append(np.asarray(srv.predict(tenant, x)))
        else:
            srv.submit(tenant, x, y)
    srv.drain()
    return np.asarray(reads)


def _close(got, want, tol=STREAM_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


def _same_decisions(tsrv, jsrv):
    assert tsrv.metrics.snapshot()["counters"] == \
        jsrv.metrics.snapshot()["counters"]
    assert tsrv.resident == jsrv.resident
    assert tsrv.hit_rate() == jsrv.hit_rate()
    assert tsrv.policy.state_dict() == convert.policy_state(
        jsrv.policy.state_dict())
    for t in range(TENANTS):
        assert tsrv.log.size(t) == jsrv.log.size(t)


# ---------------------------------------------------------------------------
# SlotPolicy: exactly repro's decisions
# ---------------------------------------------------------------------------


def _policy_events(seed, n, tenants=12):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["touch", "admit", "release", "move", "force"],
                       size=n, p=[0.4, 0.35, 0.1, 0.05, 0.1])
    return [(str(k), int(t)) for k, t in zip(kinds,
                                              rng.integers(0, tenants, n))]


def _drive(pol, events):
    trace = []
    for kind, tenant in events:
        if kind == "touch":
            pol.touch(tenant)
        elif kind in ("admit", "force"):
            d = pol.admit(tenant, force=kind == "force")
            trace.append((d.action, d.slot, d.victim))
        elif kind == "release":
            trace.append(pol.release(tenant))
        elif pol.lookup(tenant) is not None:
            free = sorted(set(range(pol.slots)) - set(pol.resident.values()))
            if free:  # re-pin to the highest free slot
                pol.release(tenant)
                pol.admit(tenant)
                pol.move(tenant, free[-1])
        trace.append((pol.victim(), pol.suggest_size(), pol.occupancy,
                      tuple(sorted(pol.resident.items()))))
    return trace


@pytest.mark.parametrize("scorer", ["lru", "lfu", "cost"])
def test_slot_policy_matches_repro(scorer):
    for seed, slots in ((0, 3), (1, 4), (2, 1)):
        kw = dict(scorer=scorer, cost_fn=lambda t: 1.0 + t % 3,
                  grow_rejects=2, min_slots=1)
        jpol, tpol = JaxSlotPolicy(slots, **kw), SlotPolicy(slots, **kw)
        events = _policy_events(seed, 300)
        assert _drive(tpol, events) == _drive(jpol, events)
        assert tpol.state_dict() == convert.policy_state(jpol.state_dict())
        assert tpol.resident == jpol.resident
        # A restored policy makes the live one's decisions from here on.
        back = SlotPolicy(slots, **kw)
        back.load_state(convert.policy_state(jpol.state_dict()))
        more = _policy_events(seed + 10, 100)
        assert _drive(back, more) == _drive(jpol, more)


def test_slot_policy_set_slots_and_scorer_checks():
    pol = SlotPolicy(2, scorer="lfu", grow_rejects=2, min_slots=1)
    for t in (0, 1):
        for _ in range(3):
            pol.touch(t)
        pol.admit(t)
    for _ in range(2):
        pol.touch(7)
        assert pol.admit(7).action == "reject"
    assert pol.suggest_size() == 4
    pol.set_slots(4)
    assert pol.rejects_since_resize == 0 and pol.admit(7).slot == 2
    with pytest.raises(ValueError, match="do not fit"):
        pol.set_slots(2)
    with pytest.raises(ValueError, match="unknown scorer"):
        SlotPolicy(2, scorer="fifo")
    with pytest.raises(ValueError, match="scorer"):
        SlotPolicy(2, scorer="lru").load_state(pol.state_dict())


# ---------------------------------------------------------------------------
# The policy server against repro's
# ---------------------------------------------------------------------------


def _policy_servers(learner, policy, rebuild_mode="blocked", **kw):
    jtf, ttf = _maps()
    common = dict(bank=BANK, chunk=4, policy=policy, log_capacity=32,
                  rebuild_mode=rebuild_mode, size_watermark=4, **kw)
    jsrv = japi.make_server(learner, feature_map=jtf, mode="xla", **common)
    tsrv = api.make_server(learner, feature_map=ttf, device="cpu", **common)
    return jsrv, tsrv


@pytest.mark.parametrize("rebuild_mode", ["blocked", "scan"])
@pytest.mark.parametrize("policy", ["lru", "lfu", "cost"])
def test_policy_server_matches_repro(policy, rebuild_mode):
    jsrv, tsrv = _policy_servers("klms", policy, rebuild_mode, mu=0.3)
    requests = _zipf_requests(0, 96)
    jreads, treads = _serve(jsrv, requests), _serve(tsrv, requests)
    _same_decisions(tsrv, jsrv)
    counters = tsrv.metrics.snapshot()["counters"]
    assert counters["evictions"] > 0 and counters["readmissions"] > 0
    assert counters.get("read.cold", 0) > 0
    if policy != "lru":
        assert counters.get("admission.rejects", 0) > 0
    _close(treads, jreads)
    _close(tsrv.queue.state.theta, jsrv.queue.state.theta)
    np.testing.assert_array_equal(convert.to_numpy(tsrv.queue.state.step),
                                  np.asarray(jsrv.queue.state.step))


@pytest.mark.parametrize("learner,hp", [
    ("krls", dict(lam=1e-2, beta=0.999)),
    ("qklms", dict(sigma=1.0, mu=0.5, quant_eps=0.3, capacity=16)),
])
def test_policy_server_other_families_match_repro(learner, hp):
    """KRLS (its blocked install through the KRLS element) and QKLMS (a
    dictionary learner, sequential installs) under lru."""
    jsrv, tsrv = _policy_servers(learner, "lru", **hp)
    requests = _zipf_requests(1, 64)
    jreads, treads = _serve(jsrv, requests), _serve(tsrv, requests)
    _same_decisions(tsrv, jsrv)
    assert tsrv.metrics.count("readmissions") > 0
    _close(treads, jreads)
    for got, want in zip(tsrv.queue.state, jsrv.queue.state):
        want = np.asarray(want)
        if learner == "krls" and want.ndim == 3:  # P, normwise
            diff = np.abs(convert.to_numpy(got) - want).max((1, 2))
            assert np.all(diff <= STREAM_TOL * np.abs(want).max((1, 2)))
        else:
            _close(convert.to_numpy(got), want)


def test_policy_server_resize_moves_rows_bitwise():
    """Server.resize: growth keeps every resident row; a shrink below the
    occupancy evicts the coldest and compacts the survivors bit for bit
    (repro's test_server_resize_compaction_preserves_resident_rows_bitwise,
    and the same decisions as repro)."""
    jsrv, tsrv = _policy_servers("klms", "lfu", mu=0.3)
    requests = [r for r in _zipf_requests(2, 80) if r[0] == "write"]
    _serve(jsrv, requests)
    _serve(tsrv, requests)
    before = {t: tenant_row(tsrv.queue.state, s)
              for t, s in tsrv.resident.items()}
    for srv in (jsrv, tsrv):
        srv.resize(8)
    assert tsrv.slots == tsrv.queue.num_tenants == 8
    for t, s in tsrv.resident.items():
        assert all(torch.equal(a, b) for a, b in
                   zip(before[t], tenant_row(tsrv.queue.state, s)))
    assert not bool(tsrv.queue.state.theta[BANK:].any())
    for srv in (jsrv, tsrv):
        srv.resize(2)
    assert tsrv.slots == 2 and tsrv.policy.occupancy <= 2
    assert tsrv.resident == jsrv.resident
    for t, s in tsrv.resident.items():
        assert s < 2
        assert all(torch.equal(a, b) for a, b in
                   zip(before[t], tenant_row(tsrv.queue.state, s)))
    _same_decisions(tsrv, jsrv)
    with pytest.raises(ValueError, match="power of two"):
        tsrv.resize(3)
    requests = _zipf_requests(3, 40)
    _close(_serve(tsrv, requests), _serve(jsrv, requests))
    _same_decisions(tsrv, jsrv)


def test_policy_server_auto_resize_matches_repro():
    jsrv, tsrv = _policy_servers("klms", {"scorer": "lfu", "grow_rejects": 2},
                                 mu=0.3, auto_resize=True)
    requests = _zipf_requests(4, 96)
    _close(_serve(tsrv, requests), _serve(jsrv, requests))
    assert tsrv.metrics.count("resizes") > 0
    assert tsrv.slots == jsrv.slots
    _same_decisions(tsrv, jsrv)
    _close(tsrv.queue.state.theta, jsrv.queue.state.theta)


def test_policy_server_cold_read_returns_zeros_without_admitting():
    _, ttf = _maps()
    srv = api.make_server("klms", feature_map=ttf, bank=2, chunk=4, mu=0.3,
                          policy="lru", device="cpu")
    q = np.ones(D_IN, np.float32)
    one = srv.predict(17, q)
    assert one.shape == () and float(one) == 0.0
    block = srv.predict(17, np.ones((5, D_IN), np.float32))
    assert block.shape == (5,) and not bool(block.any())
    assert srv.policy.lookup(17) is None
    assert srv.metrics.count("read.cold") == 2
    assert srv.metrics.count("bank.misses") == 2 and srv.hit_rate() == 0.0


def test_policy_server_rejection_logs_but_does_not_train():
    _, ttf = _maps()
    srv = api.make_server("klms", feature_map=ttf, bank=1, chunk=4, mu=0.3,
                          policy="lfu", log_capacity=8, device="cpu")
    x = np.ones(D_IN, np.float32)
    for _ in range(3):
        srv.submit(0, x, 1.0)
    srv.drain()
    theta = srv.queue.state.theta.clone()
    srv.submit(42, x, 1.0)  # one touch against the incumbent's three
    srv.drain()
    assert srv.metrics.count("admission.rejects") == 1
    assert srv.log.size(42) == 1 and srv.policy.lookup(42) is None
    assert torch.equal(theta, srv.queue.state.theta)
    with pytest.raises(ValueError, match="shape"):
        srv.submit(5, np.ones(D_IN + 1), 1.0)
    assert srv.policy.clock == 4 and srv.log.size(5) == 0


def test_policy_server_lifecycle_and_reset():
    """evict / readmit / reset_tenant through the policy, then reset: the
    queue, the replica, the logs, the residency and the policy's clocks
    start again from zero."""
    jsrv, tsrv = _policy_servers("klms", "lru", mu=0.3)
    requests = _zipf_requests(5, 48)
    _serve(jsrv, requests)
    _serve(tsrv, requests)
    tenant = next(iter(tsrv.resident))
    for srv in (jsrv, tsrv):
        srv.evict(tenant)
        assert srv.evict(tenant) == 0
    assert tenant not in tsrv.resident
    assert tsrv.readmit(tenant) == jsrv.readmit(tenant) > 0
    assert tsrv.readmit(tenant) == 0
    slot = tsrv.resident[tenant]
    _close(tsrv.queue.state.theta[slot], jsrv.queue.state.theta[slot])
    for srv in (jsrv, tsrv):
        srv.reset_tenant(tenant)
    assert tsrv.log.size(tenant) == 0 and tenant in tsrv.resident
    assert not bool(tsrv.queue.state.theta[slot].any())
    _same_decisions(tsrv, jsrv)
    tsrv.reset()
    pol = tsrv.policy
    assert pol.clock == 0 and not pol.last_touch and not pol.touches
    assert tsrv.resident == {} and pol.slots == BANK
    assert tsrv.snapshot.version == 0 and tsrv.queue.ticks_served == 0
    assert not bool(tsrv.queue.state.theta.any())
    assert tsrv.log.tenants() == []
