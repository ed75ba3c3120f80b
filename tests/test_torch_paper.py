"""The port's paper harness held against ``repro`` on the CPU: the
generators, the Monte-Carlo summaries, the convergence theory, the
``EXPERIMENTS`` presets and each figure's realization functions.

``repro``'s figures draw their data with JAX keys inside the function, so
the figures cannot be compared across frameworks; the comparison is one
level down. The generators go through their ``*_from_noise`` functions
with the noise ``repro``'s keys draw, reconstructed here key by key; the
realization functions run one bank of runs against ``repro``'s per-run
drivers on the same numpy realizations.

Tolerances (atol and rtol): 1e-5 for a generated stream and the theory
(f32 values up to ~10; XLA and PyTorch round exp, pow and the sums
differently); ``rzz_closed_form`` at 1e-6; the Monte-Carlo estimate of
R_zz within ``repro``'s 5e-3 of the closed form; realizations at the
served-stream bound 1e-4 (KLMS, QKLMS; KRLS at lam = 1e-2, where f32 is
not the limit), ALD at sigma = 1 (tests/test_torch_learners.py says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_rff as jpaper_cfg
from repro.core import adaptive as jadaptive
from repro.core import theory as jtheory
from repro.core.klms import rff_klms_run as jax_klms_run
from repro.core.krls import rff_krls_run as jax_krls_run
from repro.core.krls_ald import ald_krls_run as jax_ald_run
from repro.core.qklms import qklms_run as jax_qklms_run
from repro.core.rff import RFF as JaxRFF
from repro.data import synthetic as jsyn
from repro_torch import paper
from repro_torch.configs import paper_rff
from repro_torch.core import adaptive, theory
from repro_torch.core.rff import RFF
from repro_torch.data import synthetic

torch.set_num_threads(2)

TOL = 1e-5
REAL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _noise(name, key, n):
    """``repro``'s draws for one realization, key by key as its
    generators split them."""
    normal = jax.random.normal
    if name == "kernel_expansion":
        kc, ka, kx, ke = jax.random.split(key, 4)
        return (normal(kc, (10, 5)), 5.0 * normal(ka, (10,)),
                1.0 * normal(kx, (n, 5)), 0.1 * normal(ke, (n,)))
    if name == "wiener":
        k0, k1, kx, ke = jax.random.split(key, 4)
        return (normal(k0, (5,)), normal(k1, (5,)), normal(kx, (n, 5)),
                0.05 * normal(ke, (n,)))
    if name == "chaotic1":
        ku, ke = jax.random.split(key)
        return 0.15 * normal(ku, (n,)), 0.01 * normal(ke, (n,))
    kv, kh, ke = jax.random.split(key, 3)
    sv = jnp.sqrt(0.0156)
    return (sv * normal(kv, (n,)), sv * normal(kh, (n,)),
            0.001 * normal(ke, (n,)))


def _reference(name, key, n):
    if name == "kernel_expansion":
        return jsyn.gen_kernel_expansion(key, num_samples=n)[:2]
    return {"wiener": jsyn.gen_nonlinear_wiener, "chaotic1": jsyn.gen_chaotic1,
            "chaotic2": jsyn.gen_chaotic2}[name](key, num_samples=n)


def _from_noise(name, noise):
    if name == "kernel_expansion":
        centers, coeffs, xs, eta = noise
        return xs, synthetic.kernel_expansion_from_noise(centers, coeffs, xs,
                                                         eta, 5.0)
    if name == "wiener":
        w0, w1, xs, eta = noise
        return xs, synthetic.nonlinear_wiener_from_noise(w0, w1, xs, eta)
    if name == "chaotic1":
        return synthetic.chaotic1_from_noise(*noise)
    return synthetic.chaotic2_from_noise(*noise)


@pytest.mark.parametrize("name", ["kernel_expansion", "wiener", "chaotic1",
                                  "chaotic2"])
def test_generators_match_repro(name):
    """Each ``*_from_noise`` on ``repro``'s draws gives ``repro``'s
    stream; two realizations stacked on a runs axis give each one's."""
    n = 300
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(11)]
    noises = [[_t(a) for a in _noise(name, k, n)] for k in keys]
    for key, noise in zip(keys, noises):
        xs, ys = _from_noise(name, noise)
        jxs, jys = _reference(name, key, n)
        _close(xs, jxs)
        _close(ys, jys)
    xs, ys = _from_noise(name, [torch.stack(a) for a in zip(*noises)])
    jxs, jys = _reference(name, keys[1], n)
    assert xs.shape[0] == ys.shape[0] == 2
    _close(xs[1], jxs)
    _close(ys[1], jys)


def test_generators_draw_on_their_device():
    gen = torch.Generator().manual_seed(0)
    data = synthetic.gen_kernel_expansion(gen, num_samples=50, runs=3)
    assert data.xs.shape == (3, 50, 5) and data.centers.shape == (3, 10, 5)
    xs, ys = synthetic.gen_nonlinear_wiener(gen, num_samples=40)
    assert xs.shape == (40, 5) and ys.shape == (40,)
    for fn in (synthetic.gen_chaotic1, synthetic.gen_chaotic2):
        xs, ys = fn(gen, num_samples=30, runs=2)
        assert xs.shape == (2, 30, 2) and bool(torch.isfinite(ys).all())


def test_make_lagged_matches_repro():
    s = np.random.default_rng(0).normal(size=20).astype(np.float32)
    np.testing.assert_array_equal(
        synthetic.make_lagged(_t(s), 4).numpy(),
        np.asarray(jsyn.make_lagged(jnp.asarray(s), 4)))


def test_monte_carlo_mse_and_ema_match_repro():
    key = jax.random.PRNGKey(4)

    def realization(k):
        return 0.3 * jax.random.normal(k, (64,))

    want = jadaptive.monte_carlo_mse(realization, key, 7)
    errs = jax.lax.map(realization, jax.random.split(key, 7))
    got = adaptive.monte_carlo_mse(_t(errs))
    _close(got, want, 1e-6)
    _close(adaptive.ema(got, 0.1), jadaptive.ema(want, 0.1), 1e-6)


def _rffs(d=3, dfeat=24, seed=0):
    rng = np.random.default_rng(seed)
    omega = (rng.normal(size=(d, dfeat)) / 1.5).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, dfeat).astype(np.float32)
    return (JaxRFF(omega=jnp.asarray(omega), bias=jnp.asarray(bias)),
            RFF(omega=_t(omega), bias=_t(bias)))


def test_theory_matches_repro():
    jrff, rff = _rffs()
    jr = jtheory.rzz_closed_form(jrff, 1.3)
    r = theory.rzz_closed_form(rff, 1.3)
    _close(r, jr, 1e-6)
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(6, 3)).astype(np.float32)
    coeffs = rng.normal(size=6).astype(np.float32)
    _close(theory.theta_opt(rff, _t(centers), _t(coeffs)),
           jtheory.theta_opt(jrff, jnp.asarray(centers), jnp.asarray(coeffs)))
    _close(theory.max_stable_mu(r), jtheory.max_stable_mu(jr))
    _close(theory.steady_state_mse(r, 0.7, 0.1),
           jtheory.steady_state_mse(jr, 0.7, 0.1))
    a0 = 0.2 * np.eye(24, dtype=np.float32)
    _close(theory.mse_evolution(r, _t(a0), 0.5, 0.1, 40),
           jtheory.mse_evolution(jr, jnp.asarray(a0), 0.5, 0.1, 40))
    mc = theory.rzz_monte_carlo(rff, 1.3, torch.Generator().manual_seed(1),
                                150_000)
    _close(mc, r, 5e-3)


def test_experiments_match_repro():
    assert list(paper_rff.EXPERIMENTS) == list(jpaper_cfg.EXPERIMENTS)
    for name, exp in paper_rff.EXPERIMENTS.items():
        assert (dataclasses.asdict(exp)
                == dataclasses.asdict(jpaper_cfg.EXPERIMENTS[name]))
    fields = [[f.name for f in dataclasses.fields(m.PaperExperiment)]
              for m in (paper_rff, jpaper_cfg)]
    assert fields[0] == fields[1]


def _realizations(n=240, runs=2):
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(runs, n, 5)).astype(np.float32)
    w = rng.normal(size=(runs, 5))
    ys = (np.einsum("rnd,rd->rn", xs, w) + 0.1 * np.einsum(
        "rnd,rd->rn", xs, w) ** 2 + 0.05 * rng.normal(size=(runs, n)))
    return xs, ys.astype(np.float32)


@pytest.mark.parametrize("family", ["klms", "krls", "qklms", "ald"])
def test_realizations_match_repro(family):
    """A figure's bank of runs against ``repro``'s driver run by run, on
    the same numpy realizations (2 runs of 240 samples)."""
    xs, ys = _realizations()
    jrff, rff = _rffs(5, 96, 2)
    if family == "klms":
        _, errs = paper.klms_realizations(rff, _t(xs), _t(ys), 0.5, chunk=64)
        want = [jax_klms_run(jrff, x, y, 0.5)[1].error for x, y in zip(xs, ys)]
    elif family == "krls":
        _, errs = paper.krls_realizations(rff, _t(xs), _t(ys), 1e-2, 0.9995,
                                          chunk=64)
        want = [jax_krls_run(jrff, x, y, 1e-2, 0.9995)[1].error
                for x, y in zip(xs, ys)]
    elif family == "qklms":
        state, errs = paper.qklms_realizations(_t(xs), _t(ys), 5.0, 1.0, 5.0,
                                               64)
        finals = [jax_qklms_run(x, y, 5.0, 1.0, 5.0, 64)
                  for x, y in zip(xs, ys)]
        want = [f[1].error for f in finals]
        assert state.size.tolist() == [int(f[0].size) for f in finals]
    else:
        state, errs = paper.ald_realizations(_t(xs), _t(ys), 1.0, 5e-3, 32)
        finals = [jax_ald_run(x, y, 1.0, 5e-3, 32) for x, y in zip(xs, ys)]
        want = [f[1].error for f in finals]
        assert state.size.tolist() == [int(f[0].size) for f in finals]
    assert errs.shape == (2, 240)
    for got, w in zip(errs, want):
        _close(got, w, REAL_TOL)


@pytest.mark.parametrize("fig,kw", [
    (paper.fig1_convergence, dict(num_samples=600, rff_dim=64)),
    (paper.fig2a_klms_vs_qklms, dict(num_samples=150)),
    (paper.fig2b_krls, dict(num_samples=150)),
    (paper.fig3a_chaotic1, dict(num_samples=120)),
    (paper.fig3b_chaotic2, dict(num_samples=120)),
    (paper.table1_highdim, dict(num_samples=120)),
], ids=["fig1", "fig2a", "fig2b", "fig3a", "fig3b", "highdim"])
def test_figures_run(fig, kw):
    """Each figure at 2 runs and a few hundred samples: ``repro``'s
    return shape, finite numbers, and on the CPU (plain versions on both
    sides) a ``check_ref`` difference of exactly 0."""
    us, derived, detail = fig(runs=2, device="cpu", check_ref=True, **kw)
    assert us > 0 and np.isfinite(derived)
    refs = [k for k in detail if k.startswith(("ref_rel_", "ref_maxrel_"))]
    assert len(refs) == 2 and all(detail[k] == 0.0 for k in refs)
    f64 = [k for k in detail if k.startswith("f64_maxrel_")]
    assert len(f64) == (2 if fig is paper.fig2b_krls else 0)
    if f64:  # one plain f32 run on both sides: the same distance
        assert detail[f64[0]] == detail[f64[1]] < 1e-3
    assert detail["runs"] == 2


def test_table1_reuses_figures():
    figs = {name: fn(runs=2, num_samples=n_, device="cpu")[2]
            for name, fn, n_ in (("example2", paper.fig2a_klms_vs_qklms, 100),
                                 ("example3", paper.fig3a_chaotic1, 100),
                                 ("example4", paper.fig3b_chaotic2, 100))}
    us, derived, rows = paper.table1_timing(figures=figs, device="cpu")
    assert sorted(rows) == ["example2", "example3", "example4"]
    assert derived == pytest.approx(
        np.mean([figs[k]["speedup"] for k in rows]))
    _, ratio, detail = paper.orf_vs_iid(num_seeds=2, device="cpu")
    assert ratio > 0 and set(detail) == {"rmse_iid", "rmse_orthogonal"}


def test_krls_f32_horizon():
    """The f32 horizon study at a small size: on the CPU the kernel path
    is the plain one, so both f32 runs give the same window MSEs and
    depart from float64 at the same tick."""
    us, departs, detail = paper.krls_f32_horizon(
        runs=2, num_samples=300, window=100, device="cpu")
    assert us > 0 and departs == detail["departs_plain_f32"]
    assert detail["mse_kernel"] == detail["mse_plain_f32"]
    assert len(detail["mse_float64"]) == 3
    assert all(np.isfinite(v) for v in detail["mse_float64"])
