"""The port's KRLS serving slice held against ``repro`` on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through the
``repro`` function and its ``repro_torch`` counterpart (``device="cpu"``,
which runs each kernel's plain PyTorch version). ``repro`` runs its
``ref.py`` oracles (``mode="xla"``), and the Pallas kernels themselves in
interpret mode at two tiny shapes.

Tolerances:
* one step or one chunk: 1e-5 atol and rtol, the bound of
  tests/test_chunked.py::test_krls_chunk_kernel_sweep, on the same kind of
  well-conditioned P (10 I + A A^T). XLA and PyTorch sum the projection,
  P z and the dot products in different orders and their cos differ by
  an ulp.
* a served stream at lam = 1e-2: 1e-4 atol and rtol, the bound of
  tests/test_chunked.py::test_micro_batch_queue_matches_sequential for a
  KRLS queue at lam = 1e-2 (the recursion carries each tick's
  rounding into every later tick).
* a served stream at the paper's lam = 1e-4 (and sigma = 5, as in §6):
  here f32 itself is the limit. P_0 = 1e4 I, and the recursion forms O(1)
  quantities as differences of O(1e4) ones, so each f32 implementation
  carries errors of about u / lam ~ 6e-4 relative (u = 2^-24), whatever
  its summation order. The test measures that error instead of guessing
  it: the same stream runs through the port in float64 (the exact result
  to ~1e-16), and the port's f32 result must be within twice the
  reference's own f32 error of it, plus a 1e-5 floor; port vs reference
  then differ by at most three times that error (triangle inequality).
  Values are compared normwise per tenant (``|d| <= tol (1 + max|want|)``
  for theta, errors and reads, ``|dP| <= tol max|P|`` for P), because the
  entries of theta and P span orders of magnitude.
The port's own contracts (chunk == steps, split launches, masked tick,
symmetric P) are exact. The CUDA kernels are tested on the card by
tests/test_torch_cuda.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.bank import krls_bank_init as jax_krls_bank_init
from repro.core.krls import rff_krls_run as jax_krls_run
from repro.core.rff import RFF as JaxRFF
from repro.features.base import as_trig as jax_as_trig
from repro.features.base import uniform_trig_scale as jax_uniform_scale
from repro.features.random import rff_map as jax_rff_map
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import api as japi
from repro_torch import convert
from repro_torch.core import bank
from repro_torch.core.krls import rff_krls_init, rff_krls_run
from repro_torch.core.rff import RFF
from repro_torch.kernels import chunking, ops
from repro_torch.serve import api

torch.set_num_threads(2)

TOL = 1e-5
STREAM_TOL = 1e-4
SWEEP = [(4, 5, 128, 4), (2, 5, 100, 6), (1, 2, 17, 3), (7, 5, 300, 4)]
B, D_IN, D_FEAT = 12, 5, 96


def _inputs(seed, bank_size, d, dfeat, tlen, symmetric=True):
    """Kernel inputs: P = 10 I + A A^T as in tests/test_chunked.py (or
    that plus a non-symmetric part), per-tenant beta in [0.9, 1)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a = 0.1 * rng.normal(size=(bank_size, dfeat, dfeat))
    pmat = 10.0 * np.eye(dfeat) + np.einsum("bij,bkj->bik", a, a)
    if not symmetric:
        pmat = pmat + 0.5 * rng.normal(size=pmat.shape)
    return dict(
        theta=(0.3 * rng.normal(size=(bank_size, dfeat))).astype(f32),
        pmat=pmat.astype(f32),
        xs=rng.normal(size=(bank_size, tlen, d)).astype(f32),
        ys=rng.normal(size=(bank_size, tlen)).astype(f32),
        mask=(rng.random((bank_size, tlen)) > 0.4).astype(f32),
        w=rng.normal(size=(d, dfeat)).astype(f32),
        b=rng.uniform(0, 2 * np.pi, size=dfeat).astype(f32),
        s=np.asarray(jax_uniform_scale(dfeat)),
        beta=rng.uniform(0.9, 1.0, size=bank_size).astype(f32),
    )


def _t(a):
    return convert.tensor(a, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        convert.to_numpy(got) if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=tol, rtol=tol,
    )


def _chunk_args(a):
    return [_t(a[k]) for k in ("theta", "pmat", "xs", "ys", "w", "b", "beta")]


@pytest.mark.parametrize("bank_size,d,dfeat,tlen", SWEEP)
def test_krls_step_matches_repro(bank_size, d, dfeat, tlen):
    a = _inputs(0, bank_size, d, dfeat, tlen)
    args = (a["theta"], a["pmat"], a["xs"][:, 0], a["ys"][:, 0], a["w"],
            a["b"], a["beta"], a["s"])
    want = jref.rff_krls_bank_step_ref(*args)
    got = ops.rff_krls_bank_step(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bank_size,d,dfeat,tlen", SWEEP)
@pytest.mark.parametrize("masked", [False, True])
def test_krls_chunk_matches_repro(bank_size, d, dfeat, tlen, masked):
    a = _inputs(1, bank_size, d, dfeat, tlen)
    mask = a["mask"] if masked else None
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"])
    want = jref.rff_krls_bank_chunk_ref(*args, mask, a["s"])
    got = ops.rff_krls_bank_chunk(
        *map(_t, args), None if mask is None else _t(mask), _t(a["s"]))
    for g, w in zip(got, want):
        _close(g, w)


def test_krls_reads_p_rows_like_repro():
    """A P that is not symmetric: pz reads P's rows, as the reference."""
    a = _inputs(2, 3, 4, 40, 3, symmetric=False)
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"], a["mask"], a["s"])
    want = jref.rff_krls_bank_chunk_ref(*args)
    got = ops.rff_krls_bank_chunk(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(got[1], got[1].transpose(1, 2))


@pytest.mark.parametrize("bank_size,d,dfeat,tlen", [(3, 4, 17, 3),
                                                    (2, 5, 40, 2)])
def test_krls_kernels_match_repro_pallas_interpret(bank_size, d, dfeat,
                                                   tlen):
    """Against the Pallas kernels themselves, in interpret mode."""
    a = _inputs(3, bank_size, d, dfeat, tlen)
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"], a["mask"], a["s"])
    want = jops.rff_krls_bank_chunk(*args, mode="interpret")
    got = ops.rff_krls_bank_chunk(*map(_t, args))
    for g, w in zip(got, want):
        _close(g, w)
    sargs = (a["theta"], a["pmat"], a["xs"][:, 0], a["ys"][:, 0], a["w"],
             a["b"], a["beta"], a["s"])
    want = jops.rff_krls_bank_step(*sargs, mode="interpret")
    got = ops.rff_krls_bank_step(*map(_t, sargs))
    for g, w in zip(got, want):
        _close(g, w)


def _stream(seed, n, d=D_IN):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    ys = np.sin(xs[:, 0]) + 0.3 * xs[:, 1] + 0.05 * rng.normal(size=n)
    return xs, ys.astype(np.float32)


@pytest.mark.parametrize("chunk", [None, 16])
def test_krls_run_matches_repro(chunk):
    """One filter over 40 samples, per tick or in chunks of 16 with a
    short remainder, against ``repro.core.krls.rff_krls_run``."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(D_IN, 64)).astype(np.float32) / 2.0
    b = rng.uniform(0, 2 * np.pi, size=64).astype(np.float32)
    xs, ys = _stream(5, 40)
    jstate, jout = jax_krls_run(JaxRFF(omega=w, bias=b), xs, ys, lam=1e-2,
                                beta=0.9995, chunk=chunk)
    tstate, tout = rff_krls_run(RFF(omega=_t(w), bias=_t(b)), _t(xs),
                                _t(ys), lam=1e-2, beta=0.9995, chunk=chunk)
    _close(tout.prediction, jout.prediction, STREAM_TOL)
    _close(tout.error, jout.error, STREAM_TOL)
    _close(tstate.theta, jstate.theta, STREAM_TOL)
    _close(tstate.pmat, jstate.pmat, STREAM_TOL)
    assert int(tstate.step) == int(jstate.step) == 40


def test_krls_bank_init_per_tenant_lam():
    jtf, ttf = _maps()
    lams = np.array([1e-4, 1e-2, 0.3, 1.0], np.float32)
    want = jax_krls_bank_init(jtf, 4, lam=lams)
    got = bank.krls_bank_init(ttf, 4, lam=_t(lams))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))
    scalar = bank.krls_bank_init(ttf, 3, lam=1e-4)
    assert scalar.pmat.shape == (3, D_FEAT, D_FEAT)
    assert scalar.pmat.is_contiguous()
    assert float(scalar.pmat[2, 5, 5]) == np.float32(1.0) / np.float32(1e-4)


def _maps(seed=0, sigma=2.0, dtype=torch.float32):
    jtf = jax_as_trig(jax_rff_map(jax.random.PRNGKey(seed), D_IN, D_FEAT,
                                  sigma))
    ttf = convert.trig_features(
        np.asarray(jtf.omega), np.asarray(jtf.bias), np.asarray(jtf.scale),
        device="cpu",
    )
    return jtf, type(ttf)(*(t.to(dtype) for t in ttf))


def _ragged(seed, n):
    """Skewed tenant choice, tenants 10 and 11 idle."""
    rng = np.random.default_rng(seed)
    p = np.array([8, 6, 5, 4, 3, 3, 2, 2, 1, 1, 0, 0], float)
    tenants = rng.choice(B, size=n, p=p / p.sum())
    xs, ys = _stream(seed + 100, n)
    return tenants, xs, ys


def _serve(servers, n=240, rounds=6):
    """The same ragged stream into every server; flush after each round,
    then drain. Returns, per server, the prior errors in serving order."""
    tenants, xs, ys = _ragged(0, n)
    errs = [[] for _ in servers]
    step = n // rounds
    for start in range(0, n, step):
        for i in range(start, start + step):
            for srv in servers:
                srv.submit(int(tenants[i]), xs[i], ys[i])
        for out, srv in zip(errs, servers):
            out.append(srv.flush())
    for out, srv in zip(errs, servers):
        out.append(srv.drain())
    return [
        np.array([e for res in out for t in sorted(res) for _, e in res[t]])
        for out in errs
    ]


def _normwise(got, want):
    """max |got - want| / (1 + max |want|), per tenant row, then the max."""
    got, want = (np.asarray(a, np.float64).reshape(len(a), -1)
                 for a in (got, want))
    return float(np.max(np.abs(got - want).max(1)
                        / (1 + np.abs(want).max(1))))


def _p_rel(got, want):
    """max |dP| / max |P| per tenant, then the max."""
    got, want = (np.asarray(a, np.float64).reshape(len(a), -1)
                 for a in (got, want))
    return float(np.max(np.abs(got - want).max(1) / np.abs(want).max(1)))


def test_krls_server_matches_repro():
    """The slice end to end at lam = 1e-2: submits, flushes, drain and
    every read, against ``repro.serve.make_server("krls")``."""
    jtf, ttf = _maps()
    hp = dict(lam=1e-2, beta=0.999)
    jsrv = japi.make_server("krls", feature_map=jtf, bank=B, chunk=4,
                            mode="xla", **hp)
    tsrv = api.make_server("krls", feature_map=ttf, bank=B, chunk=4,
                           device="cpu", **hp)
    jerr, terr = _serve([jsrv, tsrv])
    _close(terr, jerr, STREAM_TOL)
    assert np.mean(terr[-40:] ** 2) < np.mean(terr[:40] ** 2)
    jstate, tstate = jsrv.snapshot.state, tsrv.snapshot.state
    _close(tstate.theta, jstate.theta, STREAM_TOL)
    assert _p_rel(convert.to_numpy(tstate.pmat), jstate.pmat) < STREAM_TOL
    np.testing.assert_array_equal(convert.to_numpy(tstate.step),
                                  np.asarray(jstate.step))
    assert tsrv.staleness == jsrv.staleness == 0
    rng = np.random.default_rng(1)
    xq = rng.normal(size=(B, 7, D_IN)).astype(np.float32)
    _close(tsrv.predict_block(xq), jsrv.predict_block(xq), STREAM_TOL)
    for tenant in (0, 3, 11):
        _close(tsrv.predict(tenant, xq[tenant]),
               jsrv.predict(tenant, xq[tenant]), STREAM_TOL)
        _close(tsrv.predict(tenant, xq[tenant, 0]),
               jsrv.predict(tenant, xq[tenant, 0]), STREAM_TOL)


def test_krls_server_paper_lambda_within_f32_budget():
    """At the paper's lam = 1e-4, beta = 0.9995, sigma = 5 (§6) the port is
    as accurate as the reference: within twice the reference's own f32
    error of the float64 result, which the port computes on the same
    stream (the tolerance is explained in the module docstring)."""
    jtf, ttf = _maps(sigma=5.0)
    _, ttf64 = _maps(sigma=5.0, dtype=torch.float64)
    hp = dict(lam=1e-4, beta=0.9995, chunk=8)
    jsrv = japi.make_server("krls", feature_map=jtf, bank=B, mode="xla",
                            **hp)
    tsrv = api.make_server("krls", feature_map=ttf, bank=B, device="cpu",
                           **hp)
    exact = api.make_server("krls", feature_map=ttf64, bank=B,
                            device="cpu", **hp)
    jerr, terr, xerr = _serve([jsrv, tsrv, exact], n=480)
    rng = np.random.default_rng(3)
    xq = rng.normal(size=(B, 7, D_IN)).astype(np.float32)
    servers = (jsrv, tsrv, exact)

    def each(get):
        return [np.asarray(convert.to_numpy(v) if isinstance(v, torch.Tensor)
                           else v) for v in map(get, servers)]

    for name, (j, t, x), dist in (
        ("prior errors", (jerr[None], terr[None], xerr[None]), _normwise),
        ("theta", each(lambda s: s.snapshot.state.theta), _normwise),
        ("P", each(lambda s: s.snapshot.state.pmat), _p_rel),
        ("reads", each(lambda s: s.predict_block(xq)), _normwise),
    ):
        budget = dist(j, x)
        assert dist(t, x) <= 2 * budget + TOL, (name, dist(t, x), budget)
        assert dist(t, j) <= 3 * budget + TOL, (name, dist(t, j), budget)
    assert np.mean(xerr[-80:] ** 2) < np.mean(xerr[:80] ** 2)


@pytest.mark.parametrize("chunk", [None, 4])
def test_krls_run_stream_matches_repro(chunk):
    """Lockstep streams through the step op (chunk=None) or the chunk op
    with a masked remainder (chunk=4 over 10 ticks), with per-tenant
    beta through the bank tier."""
    jtf, ttf = _maps(1)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(6, 10, D_IN)).astype(np.float32)
    ys = np.cos(xs.sum(-1)).astype(np.float32)
    jstate, jout = japi.run_stream("krls", jtf, xs, ys, mode="xla",
                                   chunk=chunk, lam=1e-2, beta=0.99)
    tstate, tout = api.run_stream("krls", ttf, _t(xs), _t(ys), chunk=chunk,
                                  lam=1e-2, beta=0.99)
    for g, w in ((tstate.theta, jstate.theta), (tout.prediction,
                 jout.prediction), (tout.error, jout.error)):
        _close(g, w, STREAM_TOL)
    assert _p_rel(convert.to_numpy(tstate.pmat), jstate.pmat) < STREAM_TOL
    np.testing.assert_array_equal(convert.to_numpy(tstate.step),
                                  np.asarray(jstate.step))


def test_krls_chunk_schedule_equals_per_tick():
    """run_stream with chunk=4 (3 launches, masked remainder) equals the
    per-tick schedule bit for bit, and per-tenant beta goes through."""
    _, ttf = _maps(2)
    rng = np.random.default_rng(6)
    xs = _t(rng.normal(size=(5, 10, D_IN)).astype(np.float32))
    ys = _t(rng.normal(size=(5, 10)).astype(np.float32))
    beta = _t(np.linspace(0.95, 1.0, 5).astype(np.float32))
    state = bank.krls_bank_init(ttf, 5, lam=_t(np.full(5, 0.1, np.float32)))
    per_tick = bank.krls_bank_run(ttf, xs, ys, beta=beta, state=state)
    chunked = bank.krls_bank_run(ttf, xs, ys, beta=beta, state=state,
                                 chunk=4)
    for g, w in zip((*chunked[0], *chunked[1]), (*per_tick[0],
                                                 *per_tick[1])):
        assert torch.equal(g, w)


def test_krls_chunk_split_masked_and_symmetric():
    """Exact contracts of the chunk op: ``chunk=4`` launches equal one
    launch; a masked tick keeps theta and P bit for bit in fresh tensors;
    P' is symmetric; a chunk of T equals T steps."""
    a = _inputs(7, 6, 3, 40, 11)
    args = _chunk_args(a)
    one = ops.rff_krls_bank_chunk(*args, _t(a["mask"]), _t(a["s"]))
    split = ops.rff_krls_bank_chunk(*args, _t(a["mask"]), _t(a["s"]),
                                    chunk=4)
    for g, w in zip(split, one):
        assert torch.equal(g, w)
    assert torch.equal(one[1], one[1].transpose(1, 2))

    masked = ops.rff_krls_bank_chunk(*args, torch.zeros(6, 11), _t(a["s"]))
    assert torch.equal(masked[0], args[0]) and torch.equal(masked[1], args[1])
    assert masked[1].data_ptr() != args[1].data_ptr()
    theta, pmat = args[0], args[1]
    unmasked = ops.rff_krls_bank_chunk(*args, None, _t(a["s"]))
    for t in range(11):
        theta, pmat, pred, err = ops.rff_krls_bank_step(
            theta, pmat, args[2][:, t].contiguous(),
            args[3][:, t].contiguous(), args[4], args[5], args[6], _t(a["s"]))
        assert torch.equal(pred, unmasked[2][:, t])
        assert torch.equal(err, unmasked[3][:, t])
    assert torch.equal(theta, unmasked[0]) and torch.equal(pmat, unmasked[1])


def test_krls_sizing_and_dispatch():
    """The serving shape fits one block's shared memory (P stays in device
    memory); the CUDA path refuses CPU tensors."""
    assert chunking.krls_smem_bytes(300, 5) <= chunking.SMEM_BUDGET
    assert chunking.krls_fits(2048, 128) and not chunking.krls_fits(12_000, 5)
    assert chunking.default_chunk_t(1024, 300, 5, pmat=True) == 512
    assert chunking.default_chunk_t(1024, 12_000, 5, pmat=True) == 8
    a = _inputs(8, 2, 3, 16, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rff_krls_bank_chunk(*_chunk_args(a), mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rff_krls_bank_step(*_chunk_args(a)[:2], _t(a["xs"][:, 0]),
                               _t(a["ys"][:, 0]), _t(a["w"]), _t(a["b"]),
                               0.99, mode="cuda")


def _size_case(dfeat, d, nbytes, fits, bank=1024, tlen=1, route=None):
    """A case of the size rule: at a step (T = 1) the triangle alone picks
    the route; at (B, T) the cost rule picks it where the triangle fits."""
    if route is None:
        return pytest.param(dfeat, d, nbytes, fits, bank, tlen,
                            "resident" if fits else "compact",
                            id=f"{dfeat}-{d}-{nbytes}-{fits}")
    return pytest.param(dfeat, d, nbytes, fits, bank, tlen, route,
                        id=f"B{bank}-T{tlen}-{dfeat}-{d}-{route}")


@pytest.mark.parametrize("dfeat,d,nbytes,fits,bank,tlen,route", [
    _size_case(300, 5, 186_120, True), _size_case(335, 5, 230_600, True),
    _size_case(336, 5, 232_632, False), _size_case(400, 5, 328_120, False),
    _size_case(17, 4, 996, True), _size_case(129, 128, 36_708, True),
    _size_case(1, 1, 108, True), _size_case(2, 5, 168, True),
    # The serving flush, and its widths' step (the first case).
    _size_case(300, 5, 186_120, True, 1024, 16, "compact"),
    # Past the triangle every T takes the compact route.
    *(_size_case(336, 5, 232_632, False, bank, tlen, "compact")
      for bank, tlen in ((1, 1), (1, 2), (1024, 16), (8, 512))),
    _size_case(400, 5, 328_120, False, 1024, 512, "compact"),
    # Either side of a measured crossover (krls_breakdown.py
    # --route-crossover; the table beside chunking.krls_compact_pays).
    _size_case(300, 5, 186_120, True, 1024, 2, "resident"),
    _size_case(300, 5, 186_120, True, 1024, 4, "compact"),
    _size_case(300, 5, 186_120, True, 132, 4, "resident"),
    _size_case(300, 5, 186_120, True, 132, 8, "compact"),
    _size_case(335, 5, 230_600, True, 1, 2, "resident"),
    _size_case(335, 5, 230_600, True, 1, 4, "compact"),
    _size_case(200, 5, 84_120, True, 132, 8, "resident"),
    _size_case(200, 5, 84_120, True, 132, 16, "compact"),
    _size_case(100, 5, 22_120, True, 132, 8, "resident"),
    _size_case(100, 5, 22_120, True, 132, 16, "compact"),
    _size_case(31, 5, 2_600, True, 256, 8, "resident"),
    _size_case(31, 5, 2_600, True, 256, 16, "compact"),
    _size_case(31, 5, 2_600, True, 132, 512, "resident"),
    _size_case(256, 128, 137_296, True, 1024, 1, "resident"),
    _size_case(256, 128, 137_296, True, 1024, 2, "compact"),
])
def test_krls_resident_size_rule(dfeat, d, nbytes, fits, bank, tlen, route):
    """The resident chunk kernel keeps P's triangle in a block's shared
    memory: it fits at the paper's D = 300 and to D = 335, not at D = 336
    or 400 (d = 5); the bytes are those csrc/krls_bank.cu carves; the chunk
    wrapper takes the compact route past them at every T, and where they
    fit picks by the call's B and T (``chunking.krls_compact_pays``): the
    resident route for a step, the compact one for the serving flush."""
    from repro_torch.kernels.rff_krls_step import krls_chunk_route

    assert chunking.krls_resident_smem_bytes(dfeat, d) == nbytes
    assert (nbytes <= chunking.SMEM_BUDGET) is fits
    assert chunking.krls_resident_fits(dfeat, d) is fits
    assert krls_chunk_route(bank, tlen, dfeat, d) == route
    if fits:
        assert chunking.krls_compact_pays(bank, tlen, dfeat) is (
            route == "compact")
    assert chunking.krls_fits(dfeat, d)  # the streaming kernel takes any


def test_krls_tick_and_queue_factories():
    """make_tick / make_queue("krls") drive the bank tier: a tick advances
    step and P, a queue starts from P_0 = I / lam."""
    _, ttf = _maps()
    queue = api.make_queue("krls", ttf, 3, device="cpu", lam=0.5)
    assert torch.equal(queue.state.pmat[1], torch.eye(D_FEAT) / 0.5)
    tick = api.make_tick("krls", ttf, beta=0.99)
    state, out = tick(queue.state, torch.ones(3, D_IN), torch.ones(3))
    assert state.step.tolist() == [1, 1, 1] and out.error.shape == (3,)
    step = api.make_chunk_step("krls", ttf, beta=0.99)
    state2, out2 = step(queue.state, torch.ones(3, 1, D_IN),
                        torch.ones(3, 1), torch.ones(3, 1))
    assert torch.equal(state2.pmat, state.pmat)
    assert torch.equal(out2.error[:, 0], out.error)


def test_krls_entry_points_default_to_cuda():
    """Without a card, the KRLS entry points that place state raise unless
    the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ttf = _maps()
    for make in (lambda: api.make_server("krls", feature_map=ttf, bank=2),
                 lambda: api.make_queue("krls", ttf, 2),
                 lambda: rff_krls_init(D_FEAT)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    assert rff_krls_init(D_FEAT, device="cpu").pmat.device.type == "cpu"
