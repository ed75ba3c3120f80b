"""The replay elements' closed forms (the algebra of kernels 7 and 8 on
the card) and the KRLS step's route, held on the CPU.

The CUDA KLMS element kernel (``csrc/rff_scan.cu``) composes a chunk's
rank-1 maps in closed form (compact WY): ``A = I - Z^T (T Z)``, ``v = Z^T
(T y)``, ``T = (I + D_mu L)^-1 D_mu``. ``kernels/ref.py``
``klms_chunk_elements_wy_ref`` is that algebra in PyTorch, with T formed
by the kernel's blocks; here it is held against ``repro``'s Pallas kernel
in interpret mode and against a float64 fold. Inputs come from
``np.random.default_rng(seed)``.

Tolerances:
* against ``rff_klms_chunk_elements_pallas`` (interpret mode): 2e-6 atol
  and rtol, the bound of ``tests/test_torch_replay.py`` for the port's
  elements against ``repro``'s; a fully masked chunk is ``(I, 0)`` exactly;
* in float64 against the float64 fold: 1e-12 (the two are one algebra;
  only the summation order differs);
* at the replay shape (T = 256, d = 128, D = 2048, mu = 0.5), KLMS and
  NKLMS: the f32 closed form is no farther from a float64 fold than twice
  the f32 fold is (the card's numerical gate for kernel 7);
* the stress case (d = 5, D = 300, mu = 1.5; T's entries grow past 2): v
  within 1e-4 of max |v| of the float64 fold.

The CUDA KRLS element kernel forms a chunk's ``(g, Phi, r)`` as one
weighted Gram: ``Phi = Z^T diag(w) Z``, ``r = Z^T (w y)``, ``w_t = m_t
beta^(live ticks after t)``, Phi's lower triangle mirrored.
``krls_chunk_elements_gram_ref`` is that algebra; it is held against
``rff_krls_chunk_elements_pallas`` in interpret mode (2e-6, as above),
against the float64 fold in float64 (1e-12), at the paper's replay shape
(T = 256, d = 5, D = 300, beta = 0.9995) and the KLMS replay width (T =
256, d = 128, D = 2048, beta = 0.99) in f32 no farther from a float64 fold
than GATE times the f32 fold, and exactly: a fully masked chunk is ``(1,
0, 0)``, g is the fold's g and Phi equals Phi^T bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rff import sample_rff as jax_sample_rff
from repro.features.base import as_trig_or_none as jax_as_trig
from repro.kernels.rff_scan import (
    rff_klms_chunk_elements_pallas,
    rff_krls_chunk_elements_pallas,
)
from repro_torch import convert
from repro_torch.kernels import chunking, ref
from repro_torch.kernels.rff_krls_step import krls_chunk_route, krls_step_route

torch.set_num_threads(2)

ELEM_TOL, F64_TOL, GATE, STRESS_TOL = 2e-6, 1e-12, 2.0, 1e-4


def _t(a, dtype=np.float32):
    return convert.tensor(np.asarray(a, dtype), device="cpu")


def _inputs(seed, nc, tc, d, dfeat, dtype=np.float64):
    """xs ~ N(0, 1), ys ~ N(0, 1), W ~ N(0, 1/d), b ~ U[0, 2 pi], s =
    sqrt(2/D), as chip_smoke's replay inputs."""
    rng = np.random.default_rng(seed)
    return dict(
        xs=_t(rng.normal(size=(nc, tc, d)), dtype),
        ys=_t(rng.normal(size=(nc, tc)), dtype),
        w=_t(rng.normal(size=(d, dfeat)) / np.sqrt(d), dtype),
        b=_t(rng.uniform(0, 2 * np.pi, size=dfeat), dtype),
        s=_t(np.full(dfeat, np.sqrt(2.0 / dfeat)), dtype),
    )


def _f32(a):
    return {k: v.float() for k, v in a.items()}


def _args(a, mu):
    return a["xs"], a["ys"], a["w"], a["b"], mu, None, a["s"]


def _dist(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


@pytest.mark.parametrize("block", [64, 2])
@pytest.mark.parametrize("normalized", [False, True])
def test_wy_algebra_matches_pallas_interpret(normalized, block):
    """repro's Pallas element kernel in interpret mode against the closed
    form, with a masked remainder (chunk 2) and a fully masked chunk
    (chunk 1, which is (I, 0) exactly); ``block=2`` walks T's blocks."""
    jtf = jax_as_trig(jax_sample_rff(jax.random.PRNGKey(0), 3, 20, 1.0))
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(3, 6, 3)).astype(np.float32)
    ys = rng.normal(size=(3, 6)).astype(np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[1] = 0.0
    mask[2, 2:] = 0.0
    omega, bias, scale = (np.asarray(t) for t in (jtf.omega, jtf.bias,
                                                  jtf.scale))
    want = rff_klms_chunk_elements_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jtf.omega, jtf.bias, 0.3,
        jnp.asarray(mask), jtf.scale, normalized=normalized, interpret=True)
    a, v = ref.klms_chunk_elements_wy_ref(
        _t(xs), _t(ys), _t(omega), _t(bias), 0.3, _t(mask), _t(scale),
        normalized=normalized, block=block)
    for got, w in ((a, want[0]), (v, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ELEM_TOL,
                                   rtol=ELEM_TOL)
    assert torch.equal(a[1], torch.eye(20)) and torch.equal(v[1], torch.zeros(20))


@pytest.mark.parametrize("normalized", [False, True])
def test_wy_algebra_is_the_fold_in_float64(normalized):
    """Four of T's 64-row blocks (one partial), random masked ticks: the
    closed form and the fold agree to float64 rounding."""
    a = _inputs(3, 2, 230, 4, 48)
    mask = torch.from_numpy(
        (np.random.default_rng(4).random((2, 230)) > 0.2).astype(np.float64))
    args = (*_args(a, 0.7)[:5], mask, a["s"])
    fold = ref.klms_chunk_elements_ref(*args, normalized=normalized)
    wy = ref.klms_chunk_elements_wy_ref(*args, normalized=normalized)
    for got, want in zip(wy, fold):
        assert _dist(got, want) <= F64_TOL


@pytest.mark.parametrize("normalized", [False, True])
def test_wy_no_farther_from_float64_than_the_f32_fold(normalized):
    """kernel 7's numerical gate at chip_smoke's replay shape (T = 256, d =
    128, D = 2048, mu = 0.5): the f32 closed form's A and v are each within
    GATE times the f32 fold's own distance from the float64 fold."""
    a = _inputs(0, 1, 256, 128, 2048)
    exact = ref.klms_chunk_elements_ref(*_args(a, 0.5), normalized=normalized)
    a32 = _args(_f32(a), 0.5)
    plain = ref.klms_chunk_elements_ref(*a32, normalized=normalized)
    wy = ref.klms_chunk_elements_wy_ref(*a32, normalized=normalized)
    for got, fold, want in zip(wy, plain, exact):
        assert _dist(got, want) <= GATE * _dist(fold, want)


def test_wy_stress_case_keeps_v_within_tolerance():
    """d = 5, D = 300, mu = 1.5 over 256 ticks: T's entries grow past 2 and
    the closed form's v is several times farther from float64 than the
    fold's, but within STRESS_TOL of max |v|."""
    a = _inputs(1, 1, 256, 5, 300)
    exact = ref.klms_chunk_elements_ref(*_args(a, 1.5))
    wy = ref.klms_chunk_elements_wy_ref(*_args(_f32(a), 1.5))
    vmax = float(exact[1].abs().max())
    assert _dist(wy[1], exact[1]) <= STRESS_TOL * vmax
    assert _dist(wy[0], exact[0]) <= STRESS_TOL


def _krls_args(a, beta, mask=None):
    return a["xs"], a["ys"], a["w"], a["b"], beta, mask, a["s"]


def test_gram_algebra_matches_pallas_interpret():
    """repro's Pallas KRLS element kernel in interpret mode against the
    weighted Gram, with a masked remainder (chunk 2) and a fully masked
    chunk (chunk 1, exactly (1, 0, 0))."""
    jtf = jax_as_trig(jax_sample_rff(jax.random.PRNGKey(1), 3, 20, 1.0))
    rng = np.random.default_rng(12)
    xs = rng.normal(size=(3, 6, 3)).astype(np.float32)
    ys = rng.normal(size=(3, 6)).astype(np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[1] = 0.0
    mask[2, 4:] = 0.0
    omega, bias, scale = (np.asarray(t) for t in (jtf.omega, jtf.bias,
                                                  jtf.scale))
    want = rff_krls_chunk_elements_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jtf.omega, jtf.bias, 0.9,
        jnp.asarray(mask), jtf.scale, interpret=True)
    got = ref.krls_chunk_elements_gram_ref(
        _t(xs), _t(ys), _t(omega), _t(bias), 0.9, _t(mask), _t(scale))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ELEM_TOL,
                                   rtol=ELEM_TOL)
    assert float(got[0][1]) == 1.0
    assert not bool(got[1][1].any()) and not bool(got[2][1].any())


def test_gram_algebra_is_the_fold_in_float64():
    """Random masked ticks over two chunks: the weighted Gram and the fold
    agree to float64 rounding, and g is the fold's g bit for bit."""
    a = _inputs(5, 2, 230, 4, 48)
    mask = torch.from_numpy(
        (np.random.default_rng(6).random((2, 230)) > 0.2).astype(np.float64))
    fold = ref.krls_chunk_elements_ref(*_krls_args(a, 0.97, mask))
    gram = ref.krls_chunk_elements_gram_ref(*_krls_args(a, 0.97, mask))
    assert torch.equal(gram[0], fold[0])
    for got, want in zip(gram, fold):
        assert _dist(got, want) <= F64_TOL


@pytest.mark.parametrize("tc,d,dfeat,beta", [(256, 5, 300, 0.9995),
                                             (256, 128, 2048, 0.99)])
def test_gram_no_farther_from_float64_than_the_f32_fold(tc, d, dfeat, beta):
    """Kernel 8's numerical gate: at the paper's replay shape and at the
    KLMS replay width the f32 weighted Gram's g, Phi and r are each within
    GATE times the f32 fold's own distance from the float64 fold."""
    a = _inputs(2, 1, tc, d, dfeat)
    exact = ref.krls_chunk_elements_ref(*_krls_args(a, beta))
    a32 = _krls_args(_f32(a), beta)
    plain = ref.krls_chunk_elements_ref(*a32)
    gram = ref.krls_chunk_elements_gram_ref(*a32)
    for got, fold, want in zip(gram, plain, exact):
        assert _dist(got, want) <= GATE * _dist(fold, want)


def test_gram_exact_contracts():
    """A fully masked chunk is (1, 0, 0) exactly; Phi equals Phi^T bit for
    bit; g is the f32 fold's g bit for bit; a remainder chunk (its last
    ticks masked) equals its live ticks alone."""
    a = _f32(_inputs(8, 3, 24, 6, 37))
    mask = torch.ones(3, 24)
    mask[1] = 0
    mask[2, 10:] = 0
    g, phi, r = ref.krls_chunk_elements_gram_ref(*_krls_args(a, 0.95, mask))
    assert float(g[1]) == 1.0
    assert not bool(phi[1].any()) and not bool(r[1].any())
    assert all(torch.equal(p, p.T) for p in phi)
    fold = ref.krls_chunk_elements_ref(*_krls_args(a, 0.95, mask))
    assert torch.equal(g, fold[0])
    alone = ref.krls_chunk_elements_gram_ref(
        a["xs"][2:, :10], a["ys"][2:, :10], a["w"], a["b"], 0.95, None,
        a["s"])
    assert float(alone[0][0]) == float(g[2])
    torch.testing.assert_close(alone[1][0], phi[2], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(alone[2][0], r[2], atol=1e-6, rtol=1e-6)


def _step_case(dfeat, d, bank=1024, tlen=1, chunk=None):
    ids = f"{dfeat}-{d}" if chunk is None else f"B{bank}-T{tlen}-{dfeat}-{d}"
    return pytest.param(dfeat, d, bank, tlen, chunk, id=ids)


@pytest.mark.parametrize("dfeat,d,bank,tlen,chunk", [
    *(_step_case(dfeat, d) for dfeat, d in (
        (300, 5), (335, 5), (336, 5), (400, 5), (17, 4), (129, 128), (1, 1),
        (1024, 5), (1031, 5))),
    # The serving flush goes compact; its step, at any B, stays resident.
    _step_case(300, 5, 1024, 16, "compact"),
    _step_case(300, 5, 1, 16, "compact"),
    _step_case(31, 5, 1024, 512, "compact"),
    # Either side of a measured crossover, and past the triangle.
    _step_case(300, 5, 1024, 2, "resident"),
    _step_case(300, 5, 1024, 4, "compact"),
    _step_case(31, 5, 132, 512, "resident"),
    _step_case(336, 5, 1, 2, "compact"),
])
def test_krls_step_route(dfeat, d, bank, tlen, chunk):
    """One KRLS step goes to the resident chunk kernel at T = 1 where P's
    triangle fits a block, at any B, else to the compact chunk kernel at T
    = 1: the chunk's route at T = 1. A chunk of T ticks may take the other
    route (``chunking.krls_compact_pays``: the serving flush)."""
    fits = chunking.krls_resident_fits(dfeat, d)
    assert krls_step_route(bank, dfeat, d) == (
        "resident" if fits else "compact")
    assert krls_step_route(bank, dfeat, d) == krls_chunk_route(bank, 1, dfeat,
                                                               d)
    if chunk is not None:
        assert krls_chunk_route(bank, tlen, dfeat, d) == chunk
