"""The port's replay slice (evict -> log -> readmit) held against ``repro``.

Inputs come from ``np.random.default_rng(seed)`` (feature maps from
``repro``'s sampler, carried over with ``repro_torch.convert``) and go
through the ``repro`` function and its ``repro_torch`` counterpart on the
CPU (``device="cpu"``, where every kernel is its plain PyTorch version).
``repro`` runs its ``ref.py`` oracles (``mode="xla"``), and its Pallas
kernels 6-8 in interpret mode at one tiny shape each.

Tolerances (the bounds of ``tests/test_replay.py`` and
``tests/test_eviction.py`` where they exist):
* chunk elements, port vs repro: 2e-6 atol and rtol
  (test_replay.py::test_*_chunk_elements_kernel_sweep). The two
  frameworks sum the projection in different orders and their cos differ
  by an ulp; over at most 32 rank-1 folds that stays below 2e-6.
* the feature map: 1e-5 at f32; 2e-2 for bf16 features
  (tests/test_read_path.py's read contract).
* combine associativity: 1e-6 (test_replay.py); combining with the
  identity is exact. The port's tree reduction against the last element
  of ``jax.lax.associative_scan`` on the same elements: 1e-6, as both
  pair the elements alike and differ only in the summation order of each
  (D, D) product.
* replay_klms, every mode: 2e-5 relative in norm against repro's
  sequential state (test_replay.py:138-160). replay_krls at D = 32,
  lam = 0.1, beta = 0.99, T = 1024: 1e-5 relative for theta and P
  (test_replay.py:163-181); a warm start round-trips Phi_0 = inv(P_0),
  5e-4.
* make_server evict -> readmit against repro's same sequence, and
  against a never-evicted control: 5e-5 relative
  (test_eviction.py:210-285). Sequential replay equals the port's own
  run bit for bit, and untouched tenants equal the control's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import scan as jscan
from repro.core.klms import LMSState as JaxLMSState
from repro.core.klms import rff_klms_run as jax_klms_run
from repro.core.krls import rff_krls_run as jax_krls_run
from repro.core.rff import sample_rff as jax_sample_rff
from repro.features.base import as_trig_or_none as jax_as_trig
from repro.kernels import ops as jops
from repro.kernels.rff_features import rff_features_pallas
from repro.kernels.rff_scan import (
    rff_klms_chunk_elements_pallas,
    rff_krls_chunk_elements_pallas,
)
from repro.serve import api as japi
from repro_torch import convert
from repro_torch.core import bank, scan
from repro_torch.core.klms import rff_klms_run
from repro_torch.core.krls import rff_krls_run
from repro_torch.kernels import chunking, ops, ref
from repro_torch.serve import api
from repro_torch.serve.snapshot import ReplayLog

torch.set_num_threads(2)

ELEM_TOL = 2e-6
FEAT_TOL, BF16_TOL = 1e-5, 2e-2
KLMS_REL, KRLS_REL, WARM_REL, SERVER_REL = 2e-5, 1e-5, 5e-4, 5e-5


def _maps(d, dfeat, sigma=1.0, seed=0):
    jtf = jax_as_trig(jax_sample_rff(jax.random.PRNGKey(seed), d, dfeat, sigma))
    ttf = convert.trig_features(np.asarray(jtf.omega), np.asarray(jtf.bias),
                                np.asarray(jtf.scale), device="cpu")
    return jtf, ttf


def _stream(seed, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _t(a):
    return convert.tensor(np.asarray(a), device="cpu")


def _np(a):
    return convert.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# -- chunk elements and the feature map --------------------------------------


@pytest.mark.parametrize("tlen,chunk", [(64, 16), (100, 16), (30, 32)])
@pytest.mark.parametrize("normalized", [False, True])
def test_klms_elements_match_repro(tlen, chunk, normalized):
    jtf, ttf = _maps(5, 48)
    xs, ys = _stream(9, tlen, 5)
    want = jops.rff_klms_chunk_elements(
        jnp.asarray(xs), jnp.asarray(ys), jtf.omega, jtf.bias, 0.3, jtf.scale,
        mode="xla", chunk=chunk, normalized=normalized)
    got = ops.rff_klms_chunk_elements(
        _t(xs), _t(ys), ttf.omega, ttf.bias, 0.3, ttf.scale, chunk=chunk,
        normalized=normalized)
    for g, w in zip(got, want):
        _close(g, w, ELEM_TOL)


@pytest.mark.parametrize("tlen,chunk", [(64, 16), (100, 16), (30, 32)])
def test_krls_elements_match_repro(tlen, chunk):
    jtf, ttf = _maps(5, 48)
    xs, ys = _stream(10, tlen, 5)
    want = jops.rff_krls_chunk_elements(
        jnp.asarray(xs), jnp.asarray(ys), jtf.omega, jtf.bias, 0.9995,
        jtf.scale, mode="xla", chunk=chunk)
    got = ops.rff_krls_chunk_elements(
        _t(xs), _t(ys), ttf.omega, ttf.bias, 0.9995, ttf.scale, chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w, ELEM_TOL)


@pytest.mark.parametrize("kernel", ["features", "klms", "nklms", "krls"])
def test_plain_versions_match_pallas_interpret(kernel):
    """Kernels 6-8 of repro, run in interpret mode, against the port's
    plain versions at one tiny shape each (masked remainder included)."""
    jtf, ttf = _maps(3, 20)
    xs, ys = _stream(11, 12, 3)
    if kernel == "features":
        want = rff_features_pallas(jnp.asarray(xs), jtf.omega, jtf.bias,
                                   jtf.scale, interpret=True)
        got = ops.rff_features(_t(xs), ttf.omega, ttf.bias, ttf.scale)
        _close(got, want, FEAT_TOL)
        return
    xs_c, ys_c = xs.reshape(3, 4, 3), ys.reshape(3, 4)
    mask = np.ones((3, 4), np.float32)
    mask[2, 1:] = 0.0
    jargs = (jnp.asarray(xs_c), jnp.asarray(ys_c), jtf.omega, jtf.bias)
    targs = (_t(xs_c), _t(ys_c), ttf.omega, ttf.bias)
    if kernel == "krls":
        want = rff_krls_chunk_elements_pallas(
            *jargs, 0.99, jnp.asarray(mask), jtf.scale, interpret=True)
        got = ref.krls_chunk_elements_ref(*targs, 0.99, _t(mask), ttf.scale)
    else:
        norm = kernel == "nklms"
        want = rff_klms_chunk_elements_pallas(
            *jargs, 0.3, jnp.asarray(mask), jtf.scale, normalized=norm,
            interpret=True)
        got = ref.klms_chunk_elements_ref(*targs, 0.3, _t(mask), ttf.scale,
                                          normalized=norm)
    for g, w in zip(got, want):
        _close(g, w, ELEM_TOL)


@pytest.mark.parametrize("precision,tol", [(None, FEAT_TOL), ("bf16", BF16_TOL)])
def test_rff_features_matches_repro(precision, tol):
    jtf, ttf = _maps(6, 70)
    x = np.random.default_rng(12).normal(size=(2, 9, 6)).astype(np.float32)
    want = jops.rff_features(jnp.asarray(x), jtf.omega, jtf.bias, jtf.scale,
                             mode="xla", precision=precision)
    got = ops.rff_features(_t(x), ttf.omega, ttf.bias, ttf.scale,
                           precision=precision)
    assert got.shape == (2, 9, 70)
    assert got.dtype == (torch.bfloat16 if precision else torch.float32)
    _close(got.float(), np.asarray(want, np.float32), tol)


def test_remainder_chunk_composes_identity():
    """16 ticks at chunk=12: the second chunk has 4 live and 8 masked
    ticks, and the two elements composed equal the one 16-tick element."""
    _, ttf = _maps(3, 32)
    xs, ys = _stream(11, 16, 3)
    args = (_t(xs), _t(ys), ttf.omega, ttf.bias, 0.3, ttf.scale)
    a2, v2 = ops.rff_klms_chunk_elements(*args, chunk=12)
    a1, v1 = ops.rff_klms_chunk_elements(*args, chunk=16)
    composed = scan.affine_combine(scan.AffineElement(a2[0], v2[0]),
                                   scan.AffineElement(a2[1], v2[1]))
    _close(composed.a, a1[0], ELEM_TOL)
    _close(composed.v, v1[0], ELEM_TOL)
    g, phi, r = ops.rff_krls_chunk_elements(*args[:4], 0.99, ttf.scale,
                                            chunk=12)
    assert float(g[1]) == pytest.approx(0.99 ** 4, rel=1e-6)


def test_default_chunk_t_elements_rule():
    """Tc is the smallest power of two >= D/2, within [8, 512]."""
    got = {dfeat: chunking.default_chunk_t(1, dfeat, elements=True)
           for dfeat in (1, 16, 17, 48, 300, 1024, 2048)}
    assert got == {1: 8, 16: 8, 17: 16, 48: 32, 300: 256, 1024: 512,
                   2048: 512}


# -- element algebra and the hand-written scan --------------------------------


def test_affine_combine_associative_and_identity():
    rng = np.random.default_rng(0)
    e = [scan.klms_to_element(_t(rng.normal(size=16).astype(np.float32)),
                              torch.tensor(float(i + 1)), 0.3)
         for i in range(3)]
    left = scan.affine_combine(scan.affine_combine(e[0], e[1]), e[2])
    right = scan.affine_combine(e[0], scan.affine_combine(e[1], e[2]))
    _close(left.a, right.a, 1e-6)
    _close(left.v, right.v, 1e-6)
    ident = scan.affine_identity(16)
    for c in (scan.affine_combine(ident, e[0]), scan.affine_combine(e[0], ident)):
        assert torch.equal(c.a, e[0].a) and torch.equal(c.v, e[0].v)


def test_decay_combine_associative_and_identity():
    rng = np.random.default_rng(1)
    e = [scan.krls_to_element(_t(rng.normal(size=8).astype(np.float32)),
                              torch.tensor(float(i + 1)), 0.97)
         for i in range(3)]
    left = scan.decay_combine(scan.decay_combine(e[0], e[1]), e[2])
    right = scan.decay_combine(e[0], scan.decay_combine(e[1], e[2]))
    for f in ("g", "phi", "r"):
        _close(getattr(left, f), getattr(right, f), 1e-6)
    ident = scan.decay_identity(8)
    for c in (scan.decay_combine(ident, e[0]), scan.decay_combine(e[0], ident)):
        for f in ("g", "phi", "r"):
            assert torch.equal(getattr(c, f), getattr(e[0], f))


@pytest.mark.parametrize("family,n", [("affine", 1), ("affine", 7),
                                      ("affine", 16), ("decay", 5),
                                      ("decay", 16)])
def test_associative_scan_matches_jax(family, n):
    rng = np.random.default_rng(n)
    z = (0.3 * rng.normal(size=(n, 12))).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    if family == "affine":
        jel = jscan.klms_to_element(jnp.asarray(z), jnp.asarray(y), 0.4)
        tel = scan.klms_to_element(_t(z), _t(y), 0.4)
        jc, tc = jscan.affine_combine, scan.affine_combine
    else:
        jel = jscan.krls_to_element(jnp.asarray(z), jnp.asarray(y), 0.95)
        tel = scan.krls_to_element(_t(z), _t(y), 0.95)
        jc, tc = jscan.decay_combine, scan.decay_combine
    want = jax.jit(lambda e: jax.lax.associative_scan(jc, e))(jel)
    got = scan.tree_reduce(tc, tel)
    for g, w in zip(got, (a[-1] for a in want)):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-6)


def test_scan_element_factories_expose_algebra():
    z, y = _t(np.full(4, 0.5, np.float32)), torch.tensor(1.0)
    for maker, hp in ((scan.klms_scan_element, (0.3,)),
                      (scan.nklms_scan_element, (0.3, 1e-6)),
                      (scan.krls_scan_element, (0.99,))):
        elem = maker(*hp)
        tick = elem.to_element(z, y)
        ident = elem.identity(4)
        assert all(torch.equal(a, b)
                   for a, b in zip(elem.combine(ident, tick), tick))
        assert callable(elem.apply)


# -- replay against repro -----------------------------------------------------


@pytest.mark.parametrize("mode", ["sequential", "scan", "blocked"])
@pytest.mark.parametrize("normalized", [False, True])
def test_replay_klms_matches_repro(mode, normalized):
    jtf, ttf = _maps(4, 64)
    xs, ys = _stream(3, 200, 4)
    seq, _ = jax_klms_run(jtf, jnp.asarray(xs), jnp.asarray(ys), 0.3,
                          normalized=normalized)
    # chunk=16 leaves a masked remainder chunk (200 = 12 * 16 + 8).
    got = scan.replay_klms(ttf, _t(xs), _t(ys), 0.3, mode=mode, chunk=16,
                           normalized=normalized)
    assert _rel(got.theta, seq.theta) < KLMS_REL
    assert int(got.step) == 200


@pytest.mark.parametrize("mode", ["scan", "blocked"])
def test_replay_klms_warm_start(mode):
    jtf, ttf = _maps(4, 64)
    xs, ys = _stream(4, 200, 4)
    seq, _ = jax_klms_run(jtf, jnp.asarray(xs), jnp.asarray(ys), 0.3)
    half, _ = jax_klms_run(jtf, jnp.asarray(xs[:100]), jnp.asarray(ys[:100]),
                           0.3)
    start = convert.lms_state(np.asarray(half.theta), np.asarray(half.step),
                              device="cpu")
    got = scan.replay_klms(ttf, _t(xs[100:]), _t(ys[100:]), 0.3, state=start,
                           mode=mode, chunk=16)
    assert _rel(got.theta, seq.theta) < KLMS_REL
    assert int(got.step) == 200


@pytest.mark.parametrize("mode", ["scan", "blocked"])
def test_replay_krls_pinned_f32(mode):
    """D = 32, lam = 0.1, beta = 0.99, T = 1024: 1e-5 for theta and P."""
    jtf, ttf = _maps(4, 32)
    xs, ys = _stream(5, 1024, 4)
    seq, _ = jax_krls_run(jtf, jnp.asarray(xs), jnp.asarray(ys), lam=0.1,
                          beta=0.99)
    got = scan.replay_krls(ttf, _t(xs), _t(ys), lam=0.1, beta=0.99, mode=mode)
    assert _rel(got.theta, seq.theta) < KRLS_REL
    assert _rel(got.pmat, seq.pmat) < KRLS_REL
    assert int(got.step) == 1024


def test_replay_krls_warm_start():
    jtf, ttf = _maps(4, 32)
    xs, ys = _stream(7, 256, 4)
    seq, _ = jax_krls_run(jtf, jnp.asarray(xs), jnp.asarray(ys), lam=0.1,
                          beta=0.9995)
    half, _ = jax_krls_run(jtf, jnp.asarray(xs[:128]), jnp.asarray(ys[:128]),
                           lam=0.1, beta=0.9995)
    start = convert.rls_state(*(np.asarray(a) for a in half), device="cpu")
    got = scan.replay_krls(ttf, _t(xs[128:]), _t(ys[128:]), beta=0.9995,
                           state=start, mode="scan")
    assert _rel(got.theta, seq.theta) < WARM_REL
    assert int(got.step) == 256


@pytest.mark.parametrize("normalized", [False, True])
def test_sequential_replay_is_the_run_bitwise(normalized):
    _, ttf = _maps(4, 64)
    xs, ys = _stream(2, 150, 4)
    run, _ = rff_klms_run(ttf, _t(xs), _t(ys), 0.3, normalized=normalized)
    rep = scan.replay_klms(ttf, _t(xs), _t(ys), 0.3, mode="sequential",
                           normalized=normalized)
    assert torch.equal(rep.theta, run.theta) and int(rep.step) == 150
    if normalized:
        return
    krun, _ = rff_krls_run(ttf, _t(xs), _t(ys), lam=0.1, beta=0.9995)
    krep = scan.replay_krls(ttf, _t(xs), _t(ys), lam=0.1, beta=0.9995,
                            mode="sequential")
    assert torch.equal(krep.theta, krun.theta)
    assert torch.equal(krep.pmat, krun.pmat)


def test_replay_rejects_unknown_mode():
    _, ttf = _maps(4, 16)
    xs, ys = _stream(2, 8, 4)
    with pytest.raises(ValueError, match="unknown replay mode"):
        scan.replay_klms(ttf, _t(xs), _t(ys), 0.3, mode="tree")
    with pytest.raises(ValueError, match="unknown replay mode"):
        scan.replay_krls(ttf, _t(xs), _t(ys), mode="tree")


# -- the bank lifecycle -------------------------------------------------------


def test_klms_evict_and_rebuild_match_repro():
    jtf, ttf = _maps(3, 32)
    rng = np.random.default_rng(20)
    theta = rng.normal(size=(4, 32)).astype(np.float32)
    step = np.arange(4, dtype=np.int32)
    jstate = JaxLMSState(theta=jnp.asarray(theta), step=jnp.asarray(step))
    tstate = convert.lms_state(theta, step, device="cpu")
    jev = jbank.evict_tenant(jstate, 1)
    tev = bank.evict_tenant(tstate, 1)
    for g, w in zip(tev, jev):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert torch.equal(tstate.theta[1], _t(theta[1]))  # out of place
    assert bank.bank_size(tev) == 4
    xs, ys = _stream(21, 90, 3)
    mu = np.asarray([0.1, 0.3, 0.2, 0.4], np.float32)
    jrb = jbank.rebuild_tenant(jev, 1, jtf, jnp.asarray(xs), jnp.asarray(ys),
                               mu=jnp.asarray(mu), mode="blocked", chunk=16)
    trb = bank.rebuild_tenant(tev, 1, ttf, xs, ys, mu=_t(mu), mode="blocked",
                              chunk=16)
    assert _rel(trb.theta[1], jrb.theta[1]) < KLMS_REL
    assert int(trb.step[1]) == 90
    for b in (0, 2, 3):
        assert torch.equal(trb.theta[b], tev.theta[b])


def test_krls_evict_and_rebuild_per_tenant_lambda_match_repro():
    jtf, ttf = _maps(3, 24)
    lam = np.asarray([0.1, 0.5, 0.2], np.float32)
    beta = np.asarray([0.99, 0.995, 0.999], np.float32)
    jstate = jbank.krls_bank_init(jtf, 3, jnp.asarray(lam))
    tstate = bank.krls_bank_init(ttf, 3, _t(lam))
    jev = jbank.evict_tenant(jstate, 1, lam=jnp.asarray(lam))
    tev = bank.evict_tenant(tstate, 1, lam=_t(lam))
    for g, w in zip(tev, jev):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-7)
    xs, ys = _stream(22, 120, 3)
    jrb = jbank.rebuild_tenant(jev, 1, jtf, jnp.asarray(xs), jnp.asarray(ys),
                               lam=jnp.asarray(lam), beta=jnp.asarray(beta),
                               mode="blocked")
    trb = bank.rebuild_tenant(tev, 1, ttf, xs, ys, lam=_t(lam),
                              beta=_t(beta), mode="blocked")
    assert _rel(trb.theta[1], jrb.theta[1]) < KRLS_REL
    assert _rel(trb.pmat[1], jrb.pmat[1]) < KRLS_REL
    assert int(trb.step[1]) == 120
    assert torch.equal(trb.pmat[0], tev.pmat[0])


def test_replay_log_ring_semantics():
    log = ReplayLog(capacity=4)
    xs, ys = _stream(23, 6, 3)
    for x, y in zip(xs, ys):
        log.append(7, x, y)
    assert log.size(7) == 4 and log.dropped(7) == 2 and not log.complete(7)
    got_x, got_y = log.arrays(7)
    np.testing.assert_array_equal(got_x, xs[2:])
    np.testing.assert_array_equal(got_y, ys[2:])
    ex, ey = log.arrays(3)
    assert ex.shape == (0, 0) and ey.shape == (0,) and log.complete(3)
    log.append(1, xs[0], ys[0])
    log.clear(7)
    assert log.size(7) == 0 and log.complete(7) and log.size(1) == 1
    log.clear()
    assert log.size(1) == 0
    with pytest.raises(ValueError, match="capacity"):
        ReplayLog(capacity=0)


# -- make_server: evict -> readmit --------------------------------------------


def _obs(seed, n, tenants=3, d=3):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, tenants)), rng.normal(size=d).astype(np.float32),
             float(rng.normal())) for _ in range(n)]


def _drive(server, obs):
    for t, x, y in obs:
        server.submit(t, x, y)
    server.drain()


_HP = {"klms": dict(mu=0.3), "krls": dict(lam=0.1, beta=0.99)}


@pytest.mark.parametrize("family,mode", [
    ("klms", "scan"), ("klms", "blocked"), ("klms", "sequential"),
    ("krls", "scan"), ("krls", "blocked"),
])
def test_server_evict_readmit_matches_repro(family, mode):
    jtf, ttf = _maps(3, 32)
    kw = dict(bank=3, chunk=8, log_capacity=512, rebuild_mode=mode,
              **_HP[family])
    jsrv = japi.make_server(family, feature_map=jtf, mode="xla", **kw)
    tsrv = api.make_server(family, feature_map=ttf, device="cpu", **kw)
    ctl = api.make_server(family, feature_map=ttf, device="cpu", **kw)
    obs = _obs(7, 240)
    _drive(ctl, obs)
    for srv in (jsrv, tsrv):
        _drive(srv, obs[:100])
        srv.evict(1)
    assert tsrv.evicted == frozenset({1})
    if family == "klms":
        assert float(tsrv.snapshot.state.theta[1].abs().max()) == 0.0
    else:
        assert torch.equal(tsrv.snapshot.state.pmat[1], torch.eye(32) / 0.1)
    for srv in (jsrv, tsrv):
        _drive(srv, obs[100:])
    assert tsrv.queue.backlog()[1] == 0  # nothing queued while evicted
    n1 = sum(1 for t, _, _ in obs if t == 1)
    assert jsrv.readmit(1) == n1 and tsrv.readmit(1) == n1
    assert tsrv.evicted == frozenset()
    got, want = tsrv.snapshot.state, jsrv.snapshot.state
    assert _rel(got.theta[1], want.theta[1]) < SERVER_REL
    assert _rel(got.theta[1], ctl.snapshot.state.theta[1]) < SERVER_REL
    assert int(got.step[1]) == int(ctl.snapshot.state.step[1])
    for b in (0, 2):  # untouched tenants: bit for bit the control's
        for g, c in zip(bank.tenant_row(got, b),
                        bank.tenant_row(ctl.snapshot.state, b)):
            assert torch.equal(g, c)
    xq = np.random.default_rng(8).normal(size=(3, 5, 3)).astype(np.float32)
    _close(tsrv.predict_block(xq), jsrv.predict_block(jnp.asarray(xq)),
           1e-4)
    assert tsrv.metrics.count("evictions") == 1
    assert tsrv.metrics.count("readmissions") == 1


def test_server_sequential_readmit_is_the_run_bitwise():
    _, ttf = _maps(3, 32)
    srv = api.make_server("klms", feature_map=ttf, bank=3, chunk=8, mu=0.3,
                          log_capacity=512, rebuild_mode="sequential",
                          device="cpu")
    obs = _obs(11, 200)
    _drive(srv, obs)
    srv.evict(2)
    srv.readmit(2)
    x2 = np.stack([x for t, x, _ in obs if t == 2])
    y2 = np.asarray([y for t, _, y in obs if t == 2], np.float32)
    run, _ = rff_klms_run(ttf, _t(x2), _t(y2), 0.3)
    assert torch.equal(srv.snapshot.state.theta[2], run.theta)


def test_server_readmit_overflowed_log_is_windowed():
    """Ring overflow: readmission rebuilds fresh init + the last
    ``log_capacity`` ticks, and the log flags the truncation."""
    jtf, ttf = _maps(3, 32)
    srv = api.make_server("klms", feature_map=ttf, bank=2, chunk=8, mu=0.3,
                          log_capacity=16, device="cpu")
    obs = [(0, x, y) for _, x, y in _obs(13, 40)]
    _drive(srv, obs)
    srv.evict(0)
    assert not srv.snapshot_server.log.complete(0)
    assert srv.readmit(0) == 16
    xs = np.stack([x for _, x, _ in obs[-16:]])
    ys = np.asarray([y for _, _, y in obs[-16:]], np.float32)
    win, _ = jax_klms_run(jtf, jnp.asarray(xs), jnp.asarray(ys), 0.3)
    assert _rel(srv.snapshot.state.theta[0], win.theta) < SERVER_REL


def test_server_evict_drops_pending_and_publishes():
    _, ttf = _maps(3, 32)
    srv = api.make_server("klms", feature_map=ttf, bank=2, chunk=16, mu=0.3,
                          log_capacity=64, publish_every=1000, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        srv.submit(0, rng.normal(size=3).astype(np.float32), 1.0)
    version = srv.snapshot.version
    assert srv.evict(0) == 5
    assert srv.queue.backlog() == [0, 0]
    assert srv.snapshot.version == version + 1  # eviction publishes
    assert srv.snapshot_server.log.size(0) == 5
    assert srv.readmit(0) == 5
    with pytest.raises(ValueError, match="not evicted"):
        srv.readmit(0)


def test_server_reset_tenant_clears_lifecycle_state():
    _, ttf = _maps(3, 32)
    srv = api.make_server("krls", feature_map=ttf, bank=2, chunk=4, lam=0.5,
                          log_capacity=4, device="cpu")
    for t, x, y in _obs(14, 12, tenants=1):
        srv.submit(t, x, y)
    srv.drain()
    srv.evict(0)
    srv.submit(0, np.zeros(3, np.float32), 1.0)
    log = srv.snapshot_server.log
    assert not log.complete(0)
    assert srv.reset_tenant(0) == 0
    assert srv.evicted == frozenset()
    assert log.size(0) == 0 and log.complete(0)
    state = srv.snapshot.state
    assert torch.equal(state.pmat[0], torch.eye(32) / 0.5)
    assert float(state.theta[0].abs().max()) == 0.0
    assert srv.metrics.count("resets") == 1


def test_make_server_rejects_unknown_rebuild_mode():
    _, ttf = _maps(3, 8)
    with pytest.raises(ValueError, match="rebuild_mode"):
        api.make_server("klms", feature_map=ttf, device="cpu",
                        rebuild_mode="tree")
