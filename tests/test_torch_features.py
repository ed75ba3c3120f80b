"""The port's feature families, family registry and bank tiers held against
``repro`` on the CPU.

The deterministic families (qmc, gq, taylor) are built by both packages
from their own arguments, and their parameters must agree bit for bit
(both build them on the host in float64 numpy and round once). The
Monte-Carlo families are drawn by ``repro`` and carried over with
``repro_torch.convert``. Inputs come from ``np.random.default_rng``.
``repro`` runs its XLA oracles (``mode="xla"``), the port runs on
``device="cpu"`` (each kernel's plain version; taylor the generic route).

Tolerances: 1e-5 (abs + rel) for a featurize, a step, a chunk and a read
(XLA and PyTorch sum the projection and the reductions in other orders
and their cos and exp differ by an ulp); KRLS's P normwise, 1e-5 of
max|P| (its entries span orders of magnitude); the mixed KRLS bank at
``repro``'s own 1e-3 drift bound over its 80 ticks
(tests/test_features.py::test_mixed_bank_heterogeneous_families_krls).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import features as JF
from repro.core import bank as jbank
from repro.core.rff import RFF as JaxRFF
from repro.core.rff import rff_features_unscaled as jax_unscaled
from repro.features import deterministic as jdet
from repro_torch import convert
from repro_torch import features as F
from repro_torch.core import bank
from repro_torch.core.klms import LMSState, StepOut
from repro_torch.core.krls import RLSState, rff_krls_init
from repro_torch.core.rff import RFF, rff_features_unscaled
from repro_torch.kernels import ref

torch.set_num_threads(2)

TOL = 1e-5
MIXED_KRLS_TOL = 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _p_close(got, want, tol=TOL):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.abs(w).reshape(w.shape[0], -1).max(1)
    diff = np.abs(g - w).reshape(w.shape[0], -1).max(1)
    assert np.all(diff <= tol * scale), (diff / scale).max()


def _maps(family, d, dfeat, sigma, seed=0):
    """``repro``'s map and the port's: the deterministic families built by
    the port itself, the Monte-Carlo ones carried over."""
    jfm = JF.make_feature_map(family, d, dfeat, sigma,
                              key=jax.random.PRNGKey(seed))
    if family in ("rff", "orf"):
        tfm = convert.feature_map(family, [np.asarray(a) for a in jfm.params],
                                  deterministic=False, device="cpu")
    else:
        tfm = F.make_feature_map(family, d, dfeat, sigma, device="cpu")
    return jfm, tfm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Construction: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["qmc", "gq"])
@pytest.mark.parametrize("d,dfeat,sigma", [(3, 128, 1.5), (5, 300, 5.0),
                                           (2, 64, 0.5), (1, 6, 2.0)])
def test_trig_family_parameters_bitwise(family, d, dfeat, sigma):
    jfm, tfm = _maps(family, d, dfeat, sigma)
    assert tfm.family == family and tfm.deterministic
    for got, want in zip(tfm.trig, jfm.params):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(tfm.weights), np.asarray(jfm.weights))


def test_qmc_at_the_serving_width_bitwise():
    """qmc at d = 128, D = 2048 (the KLMS serving configuration). Its scale
    is float((1/m) ** 0.5) rounded once, not the Monte-Carlo sqrt(2/D)."""
    sigma = float(np.sqrt(128))
    jfm = JF.qmc_map(128, 2048, sigma)
    tfm = F.qmc_map(128, 2048, sigma, device="cpu")
    for got, want in zip(tfm.trig, jfm.params):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert float(tfm.trig.scale[0]) == np.float32((1.0 / 1024) ** 0.5)
    assert float(tfm.trig.bias[-1]) == np.float32(-np.pi / 2)


@pytest.mark.parametrize("d,degree,sigma", [(2, 5, 1.0), (5, 5, 5.0),
                                            (3, 4, 0.7), (1, 22, 1.3)])
def test_taylor_parameters_bitwise(d, degree, sigma):
    """Exponents and coefficients bit for bit; (1, 22) passes 20!, where
    int64 factorials would overflow."""
    jfm = jdet.taylor_map(d, degree, sigma)
    tfm = F.taylor_map(d, degree, sigma, device="cpu")
    assert tfm.num_features == jdet.taylor_num_features(d, degree)
    assert tfm.params.exponents.dtype == torch.int32
    for got, want in zip(tfm.params, jfm.params):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(tfm.weights), np.asarray(jfm.weights))
    assert bool(torch.isfinite(tfm.params.coeff).all())


def test_registry_matches_repro():
    assert F.FAMILIES == JF.FAMILIES
    for d, dfeat in ((2, 64), (5, 300), (3, 20)):
        jt = JF.make_feature_map("taylor", d, dfeat, 1.0)
        tt = F.make_feature_map("taylor", d, dfeat, 1.0, device="cpu")
        assert tt.num_features == jt.num_features
    fm = F.make_feature_map("rff", 4, 32, 1.0,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert fm.family == "rff" and not fm.deterministic
    gen = torch.Generator().manual_seed(0)
    assert F.make_feature_map("qmc", 3, 16, 1.0, generator=gen,
                              device="cpu").family == "qmc"


@pytest.mark.parametrize("args,match", [
    (("qmc", 3, 17, 1.0), "even"),
    (("gq", 3, 17, 1.0), "even"),
    (("gq", 128, 2048, 11.3), "cap"),
    (("fourier", 3, 16, 1.0), "unknown feature family"),
    (("rff", 3, 16, 1.0), "Monte-Carlo"),
    (("orf", 3, 16, 1.0), "Monte-Carlo"),
])
def test_registry_raises_as_repro(args, match):
    with pytest.raises(ValueError, match=match):
        JF.make_feature_map(*args)
    with pytest.raises(ValueError, match=match):
        F.make_feature_map(*args, device="cpu")


# ---------------------------------------------------------------------------
# Featurize and the bank tiers, every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", F.FAMILIES)
def test_featurize_matches_repro(family):
    jfm, tfm = _maps(family, 3, 40, 1.5)
    x = np.random.default_rng(1).normal(size=(2, 7, 3)).astype(np.float32)
    _close(F.featurize(tfm, _t(x)), JF.featurize(jfm, jnp.asarray(x)))
    assert (F.as_trig_or_none(tfm) is None) == (family == "taylor")


def test_rff_features_unscaled_matches_repro():
    rng = np.random.default_rng(2)
    omega = rng.normal(size=(3, 24)).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, 24).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    got = rff_features_unscaled(RFF(_t(omega), _t(bias)), _t(x))
    want = jax_unscaled(JaxRFF(jnp.asarray(omega), jnp.asarray(bias)),
                        jnp.asarray(x))
    _close(got, want)


def _bank_inputs(seed, bank_size, tlen, d, dfeat):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        theta=(0.1 * rng.normal(size=(bank_size, dfeat))).astype(f32),
        xs=rng.normal(size=(bank_size, tlen, d)).astype(f32),
        ys=rng.normal(size=(bank_size, tlen)).astype(f32),
        mask=(rng.random((bank_size, tlen)) > 0.3).astype(f32),
        mu=rng.uniform(0.1, 1.0, bank_size).astype(f32),
        xq=rng.normal(size=(bank_size, 5, d)).astype(f32),
    )


@pytest.mark.parametrize("family", F.FAMILIES)
def test_klms_bank_tiers_match_repro(family):
    jfm, tfm = _maps(family, 4, 48, 1.5)
    dfeat = tfm.num_features
    a = _bank_inputs(3, 5, 6, 4, dfeat)
    jst = jbank.LMSState(theta=jnp.asarray(a["theta"]),
                         step=jnp.zeros(5, jnp.int32))
    tst = LMSState(theta=_t(a["theta"]), step=torch.zeros(5, dtype=torch.int32))
    j1, jo1 = jbank.klms_bank_step(jst, jnp.asarray(a["xs"][:, 0]),
                                   jnp.asarray(a["ys"][:, 0]), jfm,
                                   jnp.asarray(a["mu"]), mode="xla")
    t1, to1 = bank.klms_bank_step(tst, _t(a["xs"][:, 0]), _t(a["ys"][:, 0]),
                                  tfm, _t(a["mu"]))
    _close(t1.theta, j1.theta)
    _close(to1.error, jo1.error)
    jc, joc = jbank.klms_bank_chunk_step(
        jst, jnp.asarray(a["xs"]), jnp.asarray(a["ys"]), jfm,
        jnp.asarray(a["mu"]), jnp.asarray(a["mask"]), mode="xla")
    tc, toc = bank.klms_bank_chunk_step(tst, _t(a["xs"]), _t(a["ys"]), tfm,
                                        _t(a["mu"]), _t(a["mask"]))
    _close(tc.theta, jc.theta)
    _close(toc.prediction, joc.prediction)
    np.testing.assert_array_equal(_np(tc.step), np.asarray(jc.step))
    for precision in (None, "bf16"):
        tol = TOL if precision is None else 2e-2
        _close(bank.bank_predict_block(tc, _t(a["xq"]), tfm,
                                       precision=precision),
               jbank.bank_predict_block(jc, jnp.asarray(a["xq"]), jfm,
                                        mode="xla", precision=precision), tol)


@pytest.mark.parametrize("family", F.FAMILIES)
def test_krls_bank_tiers_match_repro(family):
    jfm, tfm = _maps(family, 3, 32, 1.5)
    dfeat = tfm.num_features
    a = _bank_inputs(4, 3, 4, 3, dfeat)
    rng = np.random.default_rng(5)
    m = rng.normal(size=(3, dfeat, dfeat)).astype(np.float32)
    pmat = (10.0 * np.eye(dfeat, dtype=np.float32)
            + 0.1 * np.einsum("bij,bkj->bik", m, m) / dfeat).astype(np.float32)
    beta = np.float32(0.999)
    jst = jbank.RLSState(theta=jnp.asarray(a["theta"]), pmat=jnp.asarray(pmat),
                         step=jnp.zeros(3, jnp.int32))
    tst = RLSState(theta=_t(a["theta"]), pmat=_t(pmat),
                   step=torch.zeros(3, dtype=torch.int32))
    j1, jo1 = jbank.krls_bank_step(jst, jnp.asarray(a["xs"][:, 0]),
                                   jnp.asarray(a["ys"][:, 0]), jfm, beta,
                                   mode="xla")
    t1, to1 = bank.krls_bank_step(tst, _t(a["xs"][:, 0]), _t(a["ys"][:, 0]),
                                  tfm, float(beta))
    _close(t1.theta, j1.theta)
    _p_close(t1.pmat, j1.pmat)
    _close(to1.error, jo1.error)
    jc, joc = jbank.krls_bank_chunk_step(
        jst, jnp.asarray(a["xs"]), jnp.asarray(a["ys"]), jfm, beta,
        jnp.asarray(a["mask"]), mode="xla")
    tc, toc = bank.krls_bank_chunk_step(tst, _t(a["xs"]), _t(a["ys"]), tfm,
                                        float(beta), _t(a["mask"]))
    _close(tc.theta, jc.theta)
    _p_close(tc.pmat, jc.pmat)
    _close(toc.error, joc.error)
    assert torch.equal(tc.pmat, tc.pmat.mT)
    _close(bank.bank_predict_block(tc, _t(a["xq"]), tfm),
           jbank.bank_predict_block(jc, jnp.asarray(a["xq"]), jfm,
                                    mode="xla"))


def test_taylor_runs_the_generic_route_and_trig_maps_never_do(monkeypatch):
    """Routing is by the map's type: taylor reaches the generic route of
    every tier, a trig map never does (it goes through the ops)."""
    calls = []
    for name in ("_generic_klms_tick", "_generic_klms_chunk",
                 "_generic_krls_tick", "_generic_krls_chunk"):
        real = getattr(bank, name)
        monkeypatch.setattr(bank, name, lambda *args, _r=real, _n=name:
                            calls.append(_n) or _r(*args))
    a = _bank_inputs(6, 2, 3, 2, 21)
    for family in F.FAMILIES:
        _, fm = _maps(family, 2, 20, 1.0)
        if fm.num_features != 20:  # taylor: C(2 + 4, 4) = 15
            assert family == "taylor"
        dfeat = fm.num_features
        calls.clear()
        ls = bank.klms_bank_init(fm, 2)
        rs = bank.krls_bank_init(fm, 2, 1e-2)
        xs, ys = _t(a["xs"]), _t(a["ys"])
        bank.klms_bank_step(ls, xs[:, 0], ys[:, 0], fm, 0.5)
        bank.klms_bank_chunk_step(ls, xs, ys, fm, 0.5)
        bank.krls_bank_step(rs, xs[:, 0], ys[:, 0], fm, 0.999)
        bank.krls_bank_chunk_step(rs, xs, ys, fm, 0.999)
        bank.klms_bank_run(fm, xs, ys, 0.5, chunk=2)
        assert ls.theta.shape == (2, dfeat)
        if family == "taylor":
            assert sorted(set(calls)) == ["_generic_klms_chunk",
                                          "_generic_klms_tick",
                                          "_generic_krls_chunk",
                                          "_generic_krls_tick"]
        else:
            assert calls == [], (family, calls)


def test_taylor_bank_run_matches_repro_and_the_learner_bank():
    """repro's test_taylor_through_fused_bank_tiers, against repro: the
    per-tick and chunked runs of the generic route, KLMS and KRLS."""
    jfm = JF.make_feature_map("taylor", 2, 64, 1.0)
    tfm = F.make_feature_map("taylor", 2, 64, 1.0, device="cpu")
    rng = np.random.default_rng(9)
    xb = rng.normal(size=(3, 40, 2)).astype(np.float32)
    yb = np.sin(xb[..., 0]).astype(np.float32)
    _, jout = jbank.klms_bank_run(jfm, jnp.asarray(xb), jnp.asarray(yb), 0.5)
    _, tout = bank.klms_bank_run(tfm, _t(xb), _t(yb), 0.5)
    _close(tout.error, jout.error)
    _, tchunk = bank.klms_bank_run(tfm, _t(xb), _t(yb), 0.5, chunk=16)
    _close(tchunk.error, tout.error, 1e-6)
    _, jk = jbank.krls_bank_run(jfm, jnp.asarray(xb), jnp.asarray(yb), lam=1e-2)
    _, tk = bank.krls_bank_run(tfm, _t(xb), _t(yb), lam=1e-2)
    _close(tk.error, jk.error, 1e-4)


@pytest.mark.parametrize("family", ["qmc", "gq", "taylor"])
@pytest.mark.parametrize("mode", ["blocked", "scan", "sequential"])
def test_readmit_every_family_matches_repro(family, mode):
    """rebuild_tenant takes the map itself: taylor replays through
    featurize (blocked falls back to scan, as in repro)."""
    jfm, tfm = _maps(family, 3, 24, 1.5)
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(20, 3)).astype(np.float32)
    ys = np.cos(xs[:, 1]).astype(np.float32)
    jst = jbank.klms_bank_init(jfm, 3)
    tst = bank.klms_bank_init(tfm, 3)
    jr = jbank.rebuild_tenant(jst, 1, jfm, jnp.asarray(xs), jnp.asarray(ys),
                              mu=0.4, mode=mode)
    tr = bank.rebuild_tenant(tst, 1, tfm, xs, ys, mu=0.4, mode=mode)
    _close(tr.theta, jr.theta)
    jst = jbank.krls_bank_init(jfm, 3, 1e-2)
    tst = bank.krls_bank_init(tfm, 3, 1e-2)
    jr = jbank.rebuild_tenant(jst, 2, jfm, jnp.asarray(xs), jnp.asarray(ys),
                              lam=1e-2, beta=0.999, mode=mode)
    tr = bank.rebuild_tenant(tst, 2, tfm, xs, ys, lam=1e-2, beta=0.999,
                             mode=mode)
    _close(tr.theta, jr.theta, 1e-4)
    _p_close(tr.pmat, jr.pmat, 1e-4)


# ---------------------------------------------------------------------------
# Mixed-family bank and the hyperparameter tier
# ---------------------------------------------------------------------------


def _mixed(d, dfeat, families):
    jfms, tfms = [], []
    for i, family in enumerate(families):
        jfm, tfm = _maps(family, d, dfeat, 0.5, seed=i + 1)
        jfms.append(jfm)
        tfms.append(tfm)
    return jbank.stack_feature_maps(jfms), bank.stack_feature_maps(tfms)


def test_mixed_klms_bank_matches_repro():
    jtfs, ttfs = _mixed(2, 64, ("rff", "gq", "qmc", "orf"))
    assert ttfs.omega.shape == (4, 2, 64)
    rng = np.random.default_rng(10)
    xb = rng.normal(size=(4, 120, 2)).astype(np.float32)
    yb = (np.sin(2 * xb[..., 0]) * xb[..., 1]).astype(np.float32)
    mu = np.array([0.5, 0.3, 0.7, 0.4], np.float32)
    jst, jout = jbank.mixed_klms_bank_run(
        jtfs, jnp.asarray(xb), jnp.asarray(yb),
        hparams=jbank.bank_hparams(4, mu=jnp.asarray(mu)))
    hp = convert.bank_hparams(mu, np.full(4, 0.9995, np.float32),
                              np.full(4, 1e-4, np.float32), device="cpu")
    tst, tout = bank.mixed_klms_bank_run(ttfs, _t(xb), _t(yb), hparams=hp)
    _close(tout.error, jout.error)
    _close(tst.theta, jst.theta)
    np.testing.assert_array_equal(_np(tst.step), np.asarray(jst.step))


def test_mixed_krls_bank_matches_repro():
    jtfs, ttfs = _mixed(2, 48, ("rff", "gq"))
    rng = np.random.default_rng(11)
    xb = rng.normal(size=(2, 80, 2)).astype(np.float32)
    yb = np.sin(2 * xb[..., 0]).astype(np.float32)
    beta = np.array([0.999, 0.9995], np.float32)
    lam = np.array([1e-2, 1e-3], np.float32)
    jst, jout = jbank.mixed_krls_bank_run(
        jtfs, jnp.asarray(xb), jnp.asarray(yb),
        hparams=jbank.bank_hparams(2, beta=jnp.asarray(beta),
                                   lam=jnp.asarray(lam)))
    hp = bank.bank_hparams(2, beta=_t(beta), lam=_t(lam))
    tst, tout = bank.mixed_krls_bank_run(ttfs, _t(xb), _t(yb), hparams=hp)
    _close(tout.error, jout.error, MIXED_KRLS_TOL)
    np.testing.assert_array_equal(_np(tst.step), np.asarray(jst.step))


def test_stack_feature_maps_shape_mismatch():
    a = F.gq_map(2, 64, 1.0, device="cpu")
    b = F.gq_map(2, 32, 1.0, device="cpu")
    with pytest.raises(ValueError, match="share"):
        bank.stack_feature_maps([a, b])
    with pytest.raises(TypeError):
        bank.stack_feature_maps([F.taylor_map(2, 3, 1.0, device="cpu")])


def test_hp_bank_tier_matches_repro():
    """tests/test_chunked.py::test_hp_bank_generic_tier against repro
    (per-tenant mu), and a per-tenant lam KRLS init. The port's step takes
    the whole bank (leading batch dims), where repro vmaps one tenant's."""
    rng = np.random.default_rng(12)
    omega = (rng.normal(size=(5, 64)) / 5.0).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
    jrff = JaxRFF(jnp.asarray(omega), jnp.asarray(bias))
    trff = RFF(_t(omega), _t(bias))
    xb = rng.normal(size=(3, 50, 5)).astype(np.float32)
    yb = np.tanh(xb.sum(-1)).astype(np.float32)
    mus = np.array([0.2, 0.5, 0.9], np.float32)

    from repro.core.klms import lms_step as jlms_step
    from repro.core.klms import rff_klms_init as jklms_init
    from repro.core.rff import rff_features as jrff_features

    def jinit(h, k):
        return jklms_init(64)

    def jstep(s, h, x, y):
        theta, out = jlms_step(s.theta, jrff_features(jrff, x), y, h.mu)
        return type(s)(theta=theta, step=s.step + 1), out

    jhp = jbank.bank_hparams(3, mu=jnp.asarray(mus))
    jst, jout = jbank.hp_bank_run(jstep, jbank.hp_bank_init(jinit, jhp), jhp,
                                  jnp.asarray(xb), jnp.asarray(yb))

    from repro_torch.core.klms import rff_klms_init

    def tinit(h, k):
        return rff_klms_init(64, device="cpu")

    def tstep(s, h, x, y):
        theta, pred, err = ref.klms_tick_math(s.theta, trff.featurize(x), y,
                                              h.mu)
        return LMSState(theta, s.step + 1), StepOut(pred, err)

    thp = bank.bank_hparams(3, mu=_t(mus))
    tst0 = bank.hp_bank_init(tinit, thp)
    assert tst0.theta.shape == (3, 64) and tst0.step.shape == (3,)
    tst, tout = bank.hp_bank_run(tstep, tst0, thp, _t(xb), _t(yb))
    _close(tout.error, jout.error)
    _close(tst.theta, jst.theta)
    np.testing.assert_array_equal(_np(tst.step), np.asarray(jst.step))
    jone, _ = jbank.hp_bank_step(jstep, jbank.hp_bank_init(jinit, jhp), jhp,
                                 jnp.asarray(xb[:, 0]), jnp.asarray(yb[:, 0]))
    tone, _ = bank.hp_bank_step(tstep, tst0, thp, _t(xb[:, 0]), _t(yb[:, 0]))
    _close(tone.theta, jone.theta)

    lams = np.array([1e-1, 1e-2, 1e-3], np.float32)
    from repro.core.krls import rff_krls_init as jkrls_init
    jk = jbank.hp_bank_init(lambda h, k: jkrls_init(16, h.lam),
                            jbank.bank_hparams(3, lam=jnp.asarray(lams)))
    tk = bank.hp_bank_init(
        lambda h, k: rff_krls_init(16, h.lam, device="cpu"),
        bank.bank_hparams(3, lam=_t(lams)))
    np.testing.assert_array_equal(_np(tk.pmat), np.asarray(jk.pmat))


# ---------------------------------------------------------------------------
# Bank lifecycle
# ---------------------------------------------------------------------------


def test_resize_bank_grows_and_shrinks_bitwise():
    rng = np.random.default_rng(13)
    theta = _t(rng.normal(size=(4, 16)).astype(np.float32))
    st = LMSState(theta, torch.arange(4, dtype=torch.int32))
    grown = bank.resize_bank(st, 8)
    assert bank.bank_size(grown) == 8
    assert torch.equal(grown.theta[:4], st.theta)
    assert not bool(grown.theta[4:].any()) and not bool(grown.step[4:].any())
    shrunk = bank.resize_bank(grown, 2)
    assert torch.equal(shrunk.theta, st.theta[:2])
    assert bank.resize_bank(st, 4) is st
    with pytest.raises(ValueError):
        bank.resize_bank(st, 0)
    p = _t(rng.normal(size=(2, 6, 6)).astype(np.float32))
    rs = RLSState(theta[:2, :6].contiguous(), p,
                  torch.zeros(2, dtype=torch.int32))
    rg = bank.resize_bank(rs, 3, lam=1e-2)
    jg = jbank.resize_bank(
        jbank.RLSState(jnp.asarray(_np(rs.theta)), jnp.asarray(_np(p)),
                       jnp.zeros(2, jnp.int32)), 3, lam=1e-2)
    for got, want in zip(rg, jg):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_resymmetrize_tenant_is_exact_and_needs_p():
    rng = np.random.default_rng(14)
    p = rng.normal(size=(3, 5, 5)).astype(np.float32)
    st = RLSState(torch.zeros(3, 5), _t(p), torch.zeros(3, dtype=torch.int32))
    out = bank.resymmetrize_tenant(st, 1)
    assert torch.equal(out.pmat[1], out.pmat[1].T)
    assert torch.equal(out.pmat[0], st.pmat[0]) and torch.equal(
        out.pmat[2], st.pmat[2])
    assert not torch.equal(st.pmat[1], st.pmat[1].T)  # out of place
    js = jbank.resymmetrize_tenant(
        jbank.RLSState(jnp.zeros((3, 5)), jnp.asarray(p),
                       jnp.zeros(3, jnp.int32)), 1)
    np.testing.assert_array_equal(_np(out.pmat), np.asarray(js.pmat))
    with pytest.raises(ValueError, match="P leaf"):
        bank.resymmetrize_tenant(LMSState(torch.zeros(2, 4),
                                          torch.zeros(2, dtype=torch.int32)), 0)
