"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one.
The file imports neither JAX nor ``repro``, so it runs on a machine that
has only PyTorch; ``tests/conftest.py`` imports JAX, so run it there as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 at f32 (FMA contraction, another summation order in the
projection and the theta . z reduction, and ``cosf`` against PyTorch's
cos move results by a few ulp of ``|x W + b|``); 1e-3 for bf16 reads (an
f32 difference that moves z across a bf16 rounding boundary changes that
feature by one bf16 ulp, 2^-8 relative). KRLS's P is compared normwise,
1e-4 of each tenant's max |P|: its entries span 1e4 (P_0 = I / lam) down
to O(1) remainders of cancellation, whose own rounding an elementwise
bound would measure. The contracts between the two kernels of a family
are bitwise. The feature kernel is held relative to max|s| (z is at most
s in size): 1e-5 at f32, 2e-2 for bf16 features (the read contract). The
replay elements A, v, g, Phi and r are held at 1e-4 (abs + rel); a fully
masked chunk gives the identity element bit for bit. The read kernel's
two routes (a block walking all of D for 128 rows; for few rows, z by
(row tile, column tile) blocks and a reduce launch in the bank route's
order) give the same bits: a tenant read alone equals its row of the
bank's read, and both routes forced on the same inputs agree. The KLMS element is
formed in closed form (compact WY), not by the fold: at the replay shape
its A and v are each within twice the f32 fold's own distance from a
float64 fold, and two calls, or a chunk alone and among others, agree bit
for bit. The KRLS element is formed as one weighted Gram (Phi = Z^T diag(w)
Z, its lower tiles mirrored): at the paper's replay shape and at the KLMS
replay width its g, Phi and r are each within twice the f32 fold's own
distance from a float64 fold; Phi equals Phi^T, and two calls, a chunk
alone and among others and every product tile agree bit for bit. A
feature row's bits do not depend on the call's rows or on the tile's
rows. The attention kernels
(decode block, chunked linear attention, flash attention) are held at 1e-4
of max|want| at f32 (another summation order in every product and in the
online softmax) and 2e-2 of max|want| under bf16 (a feature or an output
that crosses a bf16 rounding boundary moves by one bf16 ulp; the bf16
flash kernel also rounds P to bf16 for P V); a decode block of T tokens
equals T one-token launches bit for bit, and the dv column tiles of the
decode block and of linear attention agree bit for bit with a call on
those columns alone. Of the two-route kernels, flash
attention runs bf16 on the tensor cores and f32 on the CUDA cores, and the
KRLS chunk keeps P resident in shared memory up to D = 335 at d = 5 and
takes the compact route beyond (blocks of Tc ticks, P moved once a block),
or streams P each tick when forced; the resident and streaming routes
equal T step launches bit for bit, the compact route within F32_TOL and
P_TOL (its blocks reassociate the recursion), and it is held against its
own plain version (``krls_chunk_compact_ref``) and the tick plain version
at those bounds, with its bitwise contracts (T = 1 a step, P' symmetric,
masked ticks a no-op, two calls, a tenant alone, calls of Tc in order,
tenant slabs); the KRLS step takes the chunk's route at T = 1, and the
step routes that share a tick agree bit for bit. The
distribution tier runs four gloo ranks on the card (``tests/
torch_dist_ranks.py``; NCCL refuses two ranks on one card): sharded KRLS
within 1e-5 of the dense plain run per tick and 5e-5 in blocks (the
reference tests' bounds), at D = 32768 and lam = 1e-4 within twice the
dense f32 run's own distance from a float64 run, and diffusion within
1e-4 of a plain single-process run. Every synchronizing call that
``torch.cuda``'s sync-debug mode sees in the lockstep tier's write, read
and reset sits in a ``host.wait`` span (one ``host.device_waits`` each).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.features import rff_map
from repro_torch.kernels import ops
from repro_torch.kernels.ref import default_scale
from repro_torch.kernels.chunking import predict_route
from repro_torch.kernels.rff_features import rff_features_cuda
from repro_torch.kernels.rff_klms_step import rff_klms_bank_chunk_cuda
from repro_torch.kernels.rff_krls_step import (
    rff_krls_bank_chunk_cuda,
    rff_krls_bank_step_cuda,
)
from repro_torch.kernels.rff_predict import rff_bank_predict_cuda
from repro_torch.kernels.rff_scan import (
    rff_klms_chunk_elements_cuda,
    rff_krls_chunk_elements_cuda,
)
from repro_torch.serve import make_server, make_tick

F32_TOL, BF16_TOL = 1e-4, 1e-3


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (repro_torch kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.device("cuda")


def _inputs(device, bank, tlen, d, dfeat, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return convert.tensor(np.asarray(a, np.float32), device=device)

    return dict(
        theta=t(0.3 * rng.normal(size=(bank, dfeat))),
        xs=t(rng.normal(size=(bank, tlen, d))),
        ys=t(rng.normal(size=(bank, tlen))),
        mask=t(rng.random((bank, tlen)) > 0.3),
        w=t(rng.normal(size=(d, dfeat)) / np.sqrt(d)),
        b=t(rng.uniform(0, 2 * np.pi, size=dfeat)),
        s=default_scale(dfeat, device=device),
        mu=t(rng.uniform(0.05, 1.0, size=bank)),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("bank,d,dfeat", [(64, 8, 256), (7, 5, 300),
                                          (1, 1, 17), (33, 128, 129)])
def test_kernels_match_plain(cuda_device, bank, d, dfeat):
    a = _inputs(cuda_device, bank, 5, d, dfeat)
    args = (a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"],
            a["mask"], a["s"])
    for g, w in zip(ops.rff_klms_bank_chunk(*args, mode="cuda"),
                    ops.rff_klms_bank_chunk(*args, mode="ref")):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    sargs = (a["theta"], a["xs"][:, 0].contiguous(),
             a["ys"][:, 0].contiguous(), a["w"], a["b"], a["mu"], a["s"])
    for g, w in zip(ops.rff_klms_bank_step(*sargs, mode="cuda"),
                    ops.rff_klms_bank_step(*sargs, mode="ref")):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    for precision, tol in ((None, F32_TOL), ("bf16", BF16_TOL)):
        pargs = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
        torch.testing.assert_close(
            ops.rff_bank_predict(*pargs, mode="cuda", precision=precision),
            ops.rff_bank_predict(*pargs, mode="ref", precision=precision),
            atol=tol, rtol=tol,
        )


@pytest.mark.cuda
def test_klms_bitwise_contracts(cuda_device):
    """A chunk of T equals T step launches; T=1 equals one step; a masked
    tick leaves theta bit for bit and theta' is a fresh tensor."""
    a = _inputs(cuda_device, 20, 6, 7, 300, seed=1)
    common = (a["w"], a["b"], a["mu"])
    theta_c, pred_c, err_c = ops.rff_klms_bank_chunk(
        a["theta"], a["xs"], a["ys"], *common, None, a["s"], mode="cuda")
    theta = a["theta"]
    for t in range(6):
        theta, pred, err = ops.rff_klms_bank_step(
            theta, a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous(),
            *common, a["s"], mode="cuda")
        assert torch.equal(pred, pred_c[:, t]) and torch.equal(err, err_c[:, t])
    assert torch.equal(theta, theta_c)
    masked = ops.rff_klms_bank_chunk(
        a["theta"], a["xs"], a["ys"], *common, torch.zeros_like(a["ys"]),
        a["s"], mode="cuda")
    assert torch.equal(masked[0], a["theta"])
    assert masked[0].data_ptr() != a["theta"].data_ptr()


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    a = _inputs(cuda_device, 4, 2, 3, 16)
    strided = a["xs"].transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == a["xs"].shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        rff_klms_bank_chunk_cuda(a["theta"], strided, a["ys"], a["w"],
                                 a["b"], 0.5)
    with pytest.raises(TypeError, match="float32"):
        rff_klms_bank_chunk_cuda(a["theta"].double(), a["xs"], a["ys"],
                                 a["w"], a["b"], 0.5)
    with pytest.raises(ValueError, match="shared memory"):
        wide = 60_000  # past chunking.klms_tick_plan's 58,112
        big = torch.zeros(1, wide, device=cuda_device)
        rff_klms_bank_chunk_cuda(
            big, a["xs"][:1], a["ys"][:1],
            torch.zeros(3, wide, device=cuda_device),
            torch.zeros(wide, device=cuda_device), 0.5)


# The KLMS serving shape (B, T, d, D) and its read block Q; the KRLS read
# (the paper's d = 5, D = 300); chip_smoke's ragged shapes (B, d, D).
SERVING = (1024, 16, 128, 2048)
RAGGED = [(7, 5, 300), (1, 1, 17), (33, 128, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("bank,tlen,d,dfeat", [
    SERVING, *((b, 5, d, f) for b, d, f in RAGGED), (3, 4, 6, 3000),
])
def test_klms_kernels_match_plain_at_serving_and_ragged(cuda_device, bank,
                                                        tlen, d, dfeat):
    """Both KLMS kernels (features tile, then one warp a tenant; theta in
    shared memory at D = 3000) against their plain versions."""
    a = _inputs(cuda_device, bank, tlen, d, dfeat, seed=5)
    args = (a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"],
            a["mask"], a["s"])
    for g, w in zip(ops.rff_klms_bank_chunk(*args, mode="cuda"),
                    ops.rff_klms_bank_chunk(*args, mode="ref")):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    sargs = (a["theta"], a["xs"][:, 0].contiguous(),
             a["ys"][:, 0].contiguous(), a["w"], a["b"], a["mu"], a["s"])
    for g, w in zip(ops.rff_klms_bank_step(*sargs, mode="cuda"),
                    ops.rff_klms_bank_step(*sargs, mode="ref")):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_klms_tenant_bits_do_not_depend_on_the_bank(cuda_device):
    """A tenant's theta', predictions and errors from a chunk at B = 1
    equal its row of the B = 1024 launch bit for bit, whatever its slot."""
    bank, tlen, d, dfeat = SERVING
    a = _inputs(cuda_device, bank, tlen, d, dfeat, seed=6)
    common = (a["w"], a["b"])
    full = ops.rff_klms_bank_chunk(a["theta"], a["xs"], a["ys"], *common,
                                   a["mu"], a["mask"], a["s"], mode="cuda")
    for row in (0, 517, bank - 1):
        one = ops.rff_klms_bank_chunk(
            a["theta"][row:row + 1], a["xs"][row:row + 1],
            a["ys"][row:row + 1], *common, a["mu"][row:row + 1],
            a["mask"][row:row + 1], a["s"], mode="cuda")
        for g, w in zip(one, full):
            assert torch.equal(g[0], w[row]), row


@pytest.mark.cuda
def test_klms_slabs_and_theta_placement_change_no_bit(cuda_device,
                                                      monkeypatch):
    """The ticks taken in slabs (a workspace budget of two ticks) and
    theta held in shared memory instead of registers give the same bits
    as one slab with theta in registers."""
    from repro_torch.kernels import rff_klms_step

    a = _inputs(cuda_device, 9, 7, 12, 300, seed=8)
    args = (a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"],
            a["mask"], a["s"])
    want = rff_klms_step.rff_klms_bank_chunk_cuda(*args)
    monkeypatch.setattr(rff_klms_step, "KLMS_WORKSPACE_BUDGET",
                        2 * 4 * 9 * 300)
    assert rff_klms_step.klms_slab_ticks(9, 7, 300) == 2
    slabs = rff_klms_step.rff_klms_bank_chunk_cuda(*args)
    monkeypatch.setattr(rff_klms_step, "klms_tick_plan",
                        lambda dfeat: (0, 4 * dfeat))
    shared = rff_klms_step.rff_klms_bank_chunk_cuda(*args)
    for g, s1, s2 in zip(want, slabs, shared):
        assert torch.equal(g, s1) and torch.equal(g, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("bank,qlen,d,dfeat", [
    (1024, 64, 128, 2048), (1024, 64, 5, 300),
    *((b, 13, d, f) for b, d, f in RAGGED),
])
def test_predict_kernel_matches_plain_at_read_shapes(cuda_device, precision,
                                                     bank, qlen, d, dfeat):
    """The read kernel (f32 CUDA cores; bf16 tensor cores) at the KLMS
    and KRLS read shapes and the ragged ones; two reads give the same
    bits."""
    a = _inputs(cuda_device, bank, qlen, d, dfeat, seed=9)
    pargs = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
    tol = BF16_TOL if precision else F32_TOL
    got = ops.rff_bank_predict(*pargs, mode="cuda", precision=precision)
    torch.testing.assert_close(
        got, ops.rff_bank_predict(*pargs, mode="ref", precision=precision),
        atol=tol, rtol=tol)
    assert torch.equal(got, ops.rff_bank_predict(*pargs, mode="cuda",
                                                 precision=precision))


# The read kernel's few-row route, (B, Q, d, D): one tenant at the KLMS
# serving widths, one query, two tenants, the KRLS read's and a compact
# width, the sharded KRLS predict's partial (D / n = 8192), and ragged B Q
# in {1, 7, 129} at D in {300, 2049}.
FEW_READS = [(1, 64, 128, 2048), (1, 1, 128, 2048), (2, 64, 128, 2048),
             (1, 64, 5, 300), (1, 13, 5, 400), (1, 64, 5, 8192),
             *((bq, 1, 5, dfeat) for bq in (1, 7, 129)
               for dfeat in (300, 2049))]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("bank,qlen,d,dfeat", FEW_READS)
def test_predict_few_route_matches_plain(cuda_device, precision, bank, qlen,
                                         d, dfeat):
    """The few-row route, picked by the route rule, against mode="ref";
    bit for bit the bank route forced on the same inputs, and two calls."""
    assert predict_route(bank * qlen, dfeat) == "few"
    a = _inputs(cuda_device, bank, qlen, d, dfeat, seed=10)
    pargs = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
    tol = BF16_TOL if precision else F32_TOL
    before = dict(rff_bank_predict_cuda.route_launches)
    got = ops.rff_bank_predict(*pargs, mode="cuda", precision=precision)
    assert rff_bank_predict_cuda.route_launches == {
        "bank": before["bank"], "few": before["few"] + 1}
    torch.testing.assert_close(
        got, ops.rff_bank_predict(*pargs, mode="ref", precision=precision),
        atol=tol, rtol=tol)
    assert torch.equal(got, rff_bank_predict_cuda(*pargs, precision=precision,
                                                  _route="bank"))
    assert torch.equal(got, ops.rff_bank_predict(*pargs, mode="cuda",
                                                 precision=precision))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_predict_few_route_takes_unaligned_theta(cuda_device, precision):
    """A theta whose rows start off 16 bytes (a view one float into its
    storage) takes the reduce's scalar loads: the same bits as an aligned
    copy, on both routes."""
    a = _inputs(cuda_device, 2, 64, 128, 2048, seed=13)
    store = torch.empty(2 * 2048 + 1, device=cuda_device)
    theta = store[1:].view(2, 2048)
    theta.copy_(a["theta"])
    assert theta.data_ptr() % 16 != 0 and theta.is_contiguous()
    rest = (a["xs"], a["w"], a["b"], a["s"])
    want = rff_bank_predict_cuda(a["theta"], *rest, precision=precision)
    for route in ("few", "bank"):
        assert torch.equal(want, rff_bank_predict_cuda(
            theta, *rest, precision=precision, _route=route)), route


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("bank,d,dfeat", [(1024, 128, 2048), (64, 5, 300)])
def test_predict_tenant_alone_equals_its_row(cuda_device, precision, bank, d,
                                             dfeat):
    """Every tenant's read of 64 queries alone (the few-row route) equals
    its row of the whole bank's read on the bank route, bit for bit; the
    whole read forced onto the few-row route equals it too."""
    a = _inputs(cuda_device, bank, 64, d, dfeat, seed=12)
    pargs = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
    full = rff_bank_predict_cuda(*pargs, precision=precision, _route="bank")
    assert torch.equal(full, rff_bank_predict_cuda(
        *pargs, precision=precision, _route="few"))
    for t in range(bank):
        one = ops.rff_bank_predict(a["theta"][t:t + 1], a["xs"][t:t + 1],
                                   a["w"], a["b"], a["s"], mode="cuda",
                                   precision=precision)
        assert torch.equal(one[0], full[t]), f"tenant {t}"


@pytest.mark.cuda
def test_server_runs_through_the_kernels(cuda_device):
    """make_server on the card: every flush and read launches a kernel,
    and the result agrees with the same server in mode="ref"."""
    fm = rff_map(torch.Generator().manual_seed(0), 6, 200, 2.0,
                 device=cuda_device)
    srv = make_server("klms", feature_map=fm, bank=16, chunk=4)
    ref = make_server("klms", feature_map=fm, bank=16, chunk=4, mode="ref")
    before = rff_klms_bank_chunk_cuda.launches
    rng = np.random.default_rng(2)
    for _ in range(200):
        tenant, x = int(rng.integers(0, 14)), rng.normal(size=6)
        y = 1.0 + np.sin(x[0])
        srv.submit(tenant, x, y)
        ref.submit(tenant, x, y)
    srv.drain()
    ref.drain()
    assert rff_klms_bank_chunk_cuda.launches > before
    torch.testing.assert_close(srv.snapshot.state.theta,
                               ref.snapshot.state.theta,
                               atol=F32_TOL, rtol=F32_TOL)
    xq = rng.normal(size=(16, 9, 6)).astype(np.float32)
    torch.testing.assert_close(srv.predict_block(xq), ref.predict_block(xq),
                               atol=F32_TOL, rtol=F32_TOL)


def _krls_inputs(device, bank, tlen, d, dfeat, seed=0, symmetric=True):
    """KLMS inputs plus P = 10 I + A A^T (non-symmetric on request) and
    per-tenant beta in [0.99, 1)."""
    a = _inputs(device, bank, tlen, d, dfeat, seed)
    rng = np.random.default_rng(seed + 1)
    m = 0.1 * rng.normal(size=(bank, dfeat, dfeat))
    pmat = 10.0 * np.eye(dfeat) + np.einsum("bij,bkj->bik", m, m)
    if not symmetric:
        pmat = pmat + 0.5 * rng.normal(size=pmat.shape)
    a["pmat"] = convert.tensor(pmat.astype(np.float32), device=device)
    a["beta"] = convert.tensor(
        rng.uniform(0.99, 1.0, size=bank).astype(np.float32), device=device)
    return a


def _hold_p(got, want):
    scale = want.abs().flatten(1).amax(1)
    dp = (got - want).abs().flatten(1).amax(1)
    assert bool((dp <= F32_TOL * scale).all()), float((dp / scale).max())


def _hold_krls(got, want):
    """(theta', P', preds, errs) of a kernel against its plain version."""
    for k in (0, 2, 3):
        torch.testing.assert_close(got[k], want[k], atol=F32_TOL,
                                   rtol=F32_TOL)
    _hold_p(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bank,d,dfeat,tlen,symmetric", [
    (3, 4, 17, 5, True), (5, 128, 129, 3, True), (2, 5, 1024, 4, True),
    (64, 5, 300, 16, True), (4, 5, 70, 6, False), (3, 5, 335, 4, True),
    (2, 5, 400, 3, False),
])
def test_krls_kernels_match_plain(cuda_device, bank, d, dfeat, tlen,
                                  symmetric):
    a = _krls_inputs(cuda_device, bank, tlen, d, dfeat, symmetric=symmetric)
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"], a["mask"], a["s"])
    _hold_krls(ops.rff_krls_bank_chunk(*args, mode="cuda"),
               ops.rff_krls_bank_chunk(*args, mode="ref"))
    sargs = (a["theta"], a["pmat"], a["xs"][:, 0].contiguous(),
             a["ys"][:, 0].contiguous(), a["w"], a["b"], a["beta"], a["s"])
    _hold_krls(ops.rff_krls_bank_step(*sargs, mode="cuda"),
               ops.rff_krls_bank_step(*sargs, mode="ref"))


@pytest.mark.cuda
def test_krls_bitwise_contracts(cuda_device):
    """A chunk of T equals T step launches, and equals T launches of the
    streaming step at every tick; T=1 equals one step; masked ticks leave
    theta and P bit for bit in fresh tensors; P' is exactly symmetric."""
    a = _krls_inputs(cuda_device, 9, 6, 5, 200, seed=3)
    common = (a["w"], a["b"], a["beta"])
    chunk = ops.rff_krls_bank_chunk(a["theta"], a["pmat"], a["xs"], a["ys"],
                                    *common, None, a["s"], mode="cuda")
    theta, pmat = a["theta"], a["pmat"]
    stheta, spmat = theta, pmat
    for t in range(6):
        x_t, y_t = a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous()
        theta, pmat, pred, err = ops.rff_krls_bank_step(
            theta, pmat, x_t, y_t, *common, a["s"], mode="cuda")
        assert torch.equal(pred, chunk[2][:, t])
        assert torch.equal(err, chunk[3][:, t])
        streamed = rff_krls_bank_step_cuda(stheta, spmat, x_t, y_t, *common,
                                           a["s"], _route="streaming")
        assert all(torch.equal(u, w) for u, w in
                   zip(streamed, (theta, pmat, pred, err)))
        stheta, spmat = streamed[0], streamed[1]
        if t == 0:
            one = ops.rff_krls_bank_chunk(
                a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
                a["ys"][:, :1].contiguous(), *common, None, a["s"],
                mode="cuda")
            assert torch.equal(one[0], theta) and torch.equal(one[1], pmat)
    assert torch.equal(theta, chunk[0]) and torch.equal(pmat, chunk[1])
    assert torch.equal(chunk[1], chunk[1].transpose(1, 2))
    masked = ops.rff_krls_bank_chunk(
        a["theta"], a["pmat"], a["xs"], a["ys"], *common,
        torch.zeros_like(a["ys"]), a["s"], mode="cuda")
    assert torch.equal(masked[0], a["theta"])
    assert torch.equal(masked[1], a["pmat"])
    assert masked[1].data_ptr() != a["pmat"].data_ptr()


def _krls_session(rff, xs, ys, route=None, dtype=torch.float32):
    """A session of example 2's ticks from theta = 0, P = I / lam at the
    paper's lam = 1e-4, beta = 0.9995, in calls of 16 ticks: on the route
    the chunk wrapper picks (``route`` forces one), or with ``dtype``
    float64 through the plain version. Returns (theta, P, prior errors)."""
    from repro_torch.kernels.ref import rff_krls_bank_chunk_ref

    bank, dfeat = xs.shape[0], rff.omega.shape[1]
    w, b = rff.omega.to(dtype), rff.bias.to(dtype)
    s = default_scale(dfeat, dtype, xs.device)
    theta = torch.zeros(bank, dfeat, dtype=dtype, device=xs.device)
    pmat = (torch.eye(dfeat, dtype=dtype, device=xs.device) / 1e-4).expand(
        bank, dfeat, dfeat).contiguous()
    kw = {"_route": route} if route else {}
    errs = []
    for t0 in range(0, xs.shape[1], 16):
        x = xs[:, t0:t0 + 16].to(dtype).contiguous()
        y = ys[:, t0:t0 + 16].to(dtype).contiguous()
        if dtype == torch.float64:
            theta, pmat, _, err = rff_krls_bank_chunk_ref(
                theta, pmat, x, y, w, b, 0.9995, None, s)
        else:
            theta, pmat, _, err = rff_krls_bank_chunk_cuda(
                theta, pmat, x, y, w, b, 0.9995, None, s, **kw)
        errs.append(err)
    return theta, pmat, torch.cat(errs, 1)


def _krls_session_distances(got, exact):
    """(theta, P, prior errors) of a session against the float64 one: theta
    and the errors as max |got - want| / (1 + max |want|), P as max |got -
    want| / max |want|, each per tenant, then the largest."""
    out = []
    for k, (g, w) in enumerate(zip(got, exact)):
        g, w = g.flatten(1).double(), w.flatten(1)
        scale = w.abs().amax(1) + (0.0 if k == 1 else 1.0)
        out.append(float(((g - w).abs().amax(1) / scale).max()))
    return out


def _route_case(dfeat, route, forced, bank=3, tlen=5, session=False,
                case=None):
    return pytest.param(dfeat, route, forced, bank, tlen, session,
                        id=case or f"{dfeat}-{route}-{forced}")


@pytest.mark.cuda
@pytest.mark.parametrize("dfeat,route,forced,bank,tlen,session", [
    _route_case(200, "resident", False), _route_case(31, "resident", False),
    _route_case(400, "compact", False), _route_case(400, "streaming", True),
    _route_case(300, "compact", False, 1024, 16, True, "serving-flush")])
def test_krls_chunk_routes_keep_the_contracts(cuda_device, dfeat, route,
                                              forced, bank, tlen, session):
    """Each chunk route, picked (``krls_chunk_route``: resident for the
    short calls at B = 3, compact past D = 335 at d = 5 and for the serving
    flush, B = 1024, T = 16 at D = 300) or forced (streaming): the launch
    counts its route; from a non-symmetric P, T = 1 equals one step bit for
    bit, P' is exactly symmetric and a chunk with masked ticks matches the
    plain version. A chunk of T equals T step launches on its route bit for
    bit on the resident and streaming routes (one tick's code), within
    F32_TOL and P_TOL on the compact route (its blocks reassociate the
    recursion; the serving flush's steps take the resident route); on the
    first two a chain of streaming steps also equals the routed chain at
    every tick. The step takes the chunk's route at T = 1: the routed step,
    the chunk at T = 1 and the step forced onto each route that shares its
    tick agree bit for bit. At the serving flush a 2048-tick session on the
    picked route lies within twice the resident route's distance from a
    float64 run (theta, P and every prior error)."""
    from repro_torch.kernels.rff_krls_step import krls_step_route

    kw = {"_route": route} if forced else {}
    bitwise = route != "compact"
    step_route = route if forced else krls_step_route(bank, dfeat, 5)
    a = _krls_inputs(cuda_device, bank, tlen, 5, dfeat, seed=7,
                     symmetric=False)
    common = (a["w"], a["b"], a["beta"])
    before = dict(rff_krls_bank_chunk_cuda.route_launches)
    chunk = rff_krls_bank_chunk_cuda(a["theta"], a["pmat"], a["xs"],
                                     a["ys"], *common, None, a["s"], **kw)
    after = rff_krls_bank_chunk_cuda.route_launches
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    theta, pmat = a["theta"], a["pmat"]
    stheta, spmat = theta, pmat
    preds, errs = [], []
    for t in range(tlen):
        x_t, y_t = a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous()
        theta, pmat, pred, err = rff_krls_bank_step_cuda(
            theta, pmat, x_t, y_t, *common, a["s"], **kw)
        preds.append(pred)
        errs.append(err)
        if bitwise:
            assert torch.equal(pred, chunk[2][:, t])
            assert torch.equal(err, chunk[3][:, t])
            streamed = rff_krls_bank_step_cuda(stheta, spmat, x_t, y_t,
                                               *common, a["s"],
                                               _route="streaming")
            assert all(torch.equal(u, w) for u, w in
                       zip(streamed, (theta, pmat, pred, err)))
            stheta, spmat = streamed[0], streamed[1]
        if t == 0:
            one = rff_krls_bank_chunk_cuda(
                a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
                a["ys"][:, :1].contiguous(), *common, None, a["s"], **kw)
            assert torch.equal(one[0], theta) and torch.equal(one[1], pmat)
    steps = (theta, pmat, torch.stack(preds, 1), torch.stack(errs, 1))
    if bitwise:
        assert torch.equal(theta, chunk[0]) and torch.equal(pmat, chunk[1])
    else:
        _hold_krls(chunk, steps)
    assert torch.equal(chunk[1], chunk[1].transpose(1, 2))
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], *common, a["mask"],
            a["s"])
    _hold_krls(rff_krls_bank_chunk_cuda(*args, **kw),
               ops.rff_krls_bank_chunk(*args, mode="ref"))
    # The step: routed as the chunk is; the routed step, the chunk at T = 1
    # and the step forced onto each route that shares its tick agree.
    sargs = (a["theta"], a["pmat"], a["xs"][:, 0].contiguous(),
             a["ys"][:, 0].contiguous(), *common, a["s"])
    before = dict(rff_krls_bank_step_cuda.route_launches)
    routed = rff_krls_bank_step_cuda(*sargs, **kw)
    after = rff_krls_bank_step_cuda.route_launches
    assert after[step_route] == before[step_route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    one = rff_krls_bank_chunk_cuda(
        a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
        a["ys"][:, :1].contiguous(), *common, None, a["s"], **kw)
    takes = {"resident": ("resident", "streaming"), "compact": ("compact",),
             "streaming": ("streaming",)}[step_route]
    others = [tuple(t.reshape(u.shape) for t, u in zip(one, routed))]
    others += [rff_krls_bank_step_cuda(*sargs, _route=r) for r in takes]
    for other in others:
        assert all(torch.equal(u, w) for u, w in zip(routed, other))
    if session:
        from repro_torch.core.rff import sample_rff
        from repro_torch.data.synthetic import gen_nonlinear_wiener

        del a, chunk, steps, args, sargs, routed, one, others
        rff = sample_rff(torch.Generator().manual_seed(0), 5, dfeat, 5.0,
                         device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        xs, ys = gen_nonlinear_wiener(gen, num_samples=2048, runs=bank)
        before = rff_krls_bank_chunk_cuda.route_launches[route]
        picked = _krls_session(rff, xs, ys)
        assert rff_krls_bank_chunk_cuda.route_launches[route] == before + 128
        resident = _krls_session(rff, xs, ys, route="resident")
        exact = _krls_session(rff, xs, ys, dtype=torch.float64)
        for got, eps in zip(_krls_session_distances(picked, exact),
                            _krls_session_distances(resident, exact)):
            assert got <= 2.0 * eps + 1e-5, (got, eps)


# The compact route's cases (B, T, d, D, P): the streaming width, the
# serving width of phase 24, ragged widths on either side of a tile and of
# 16-byte rows, the KLMS input width; T past one block of Tc ticks.
COMPACT_CASES = [(8, 20, 5, 400, True), (8, 20, 5, 400, False),
                 (3, 16, 5, 1024, True), (3, 5, 5, 337, False),
                 (2, 6, 5, 1031, True), (4, 16, 128, 400, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bank,tlen,d,dfeat,symmetric", COMPACT_CASES)
def test_compact_kernel_matches_plain(cuda_device, bank, tlen, d, dfeat,
                                      symmetric):
    """The compact route against its own plain version
    (``krls_chunk_compact_ref``) and against the tick plain version, each at
    the KRLS bounds (F32_TOL for theta, predictions and errors; P_TOL of
    each tenant's max |P|), with masks and per-tenant beta."""
    from repro_torch.kernels.ref import (
        krls_chunk_compact_ref,
        rff_krls_bank_chunk_ref,
    )

    a = _krls_inputs(cuda_device, bank, tlen, d, dfeat, seed=9,
                     symmetric=symmetric)
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"], a["mask"], a["s"])
    before = rff_krls_bank_chunk_cuda.route_launches["compact"]
    got = ops.rff_krls_bank_chunk(*args, mode="cuda")
    assert rff_krls_bank_chunk_cuda.route_launches["compact"] == before + 1
    _hold_krls(got, krls_chunk_compact_ref(*args))
    _hold_krls(got, rff_krls_bank_chunk_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dfeat", [400, 1031])
def test_compact_bitwise_contracts(cuda_device, dfeat):
    """On the compact route, bit for bit: a chunk at T = 1 equals a step;
    P' is exactly symmetric (from a non-symmetric P too); masked ticks
    leave theta and P in fresh tensors; two calls agree; a tenant's row does
    not depend on B or on its neighbours; a call of 2 Tc + 3 ticks equals
    calls of Tc, Tc and 3 in order."""
    from repro_torch.kernels.chunking import KRLS_COMPACT_TC as tc

    tlen = 2 * tc + 3
    a = _krls_inputs(cuda_device, 5, tlen, 5, dfeat, seed=10,
                     symmetric=False)
    common = (a["w"], a["b"], a["beta"])
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], *common, a["mask"],
            a["s"])
    full = rff_krls_bank_chunk_cuda(*args)
    again = rff_krls_bank_chunk_cuda(*args)
    assert all(torch.equal(u, v) for u, v in zip(full, again))
    assert torch.equal(full[1], full[1].transpose(1, 2))
    theta, pmat, parts = a["theta"], a["pmat"], []
    for t0, t1 in ((0, tc), (tc, 2 * tc), (2 * tc, tlen)):
        theta, pmat, pred, err = rff_krls_bank_chunk_cuda(
            theta, pmat, a["xs"][:, t0:t1].contiguous(),
            a["ys"][:, t0:t1].contiguous(), *common,
            a["mask"][:, t0:t1].contiguous(), a["s"])
        parts.append((pred, err))
    assert torch.equal(theta, full[0]) and torch.equal(pmat, full[1])
    assert torch.equal(torch.cat([p for p, _ in parts], 1), full[2])
    assert torch.equal(torch.cat([e for _, e in parts], 1), full[3])
    for row in (0, 3):  # alone, and among other neighbours
        alone = rff_krls_bank_chunk_cuda(
            *(t[row:row + 1].contiguous() for t in args[:4]), a["w"], a["b"],
            a["beta"][row:row + 1].contiguous(),
            a["mask"][row:row + 1].contiguous(), a["s"])
        assert all(torch.equal(u[0], v[row]) for u, v in zip(alone, full))
    flip = [t.flip(0).contiguous() for t in args[:4]]
    flipped = rff_krls_bank_chunk_cuda(
        *flip, a["w"], a["b"], a["beta"].flip(0).contiguous(),
        a["mask"].flip(0).contiguous(), a["s"])
    assert all(torch.equal(u.flip(0), v) for u, v in zip(flipped, full))
    masked = rff_krls_bank_chunk_cuda(*args[:7], torch.zeros_like(a["ys"]),
                                      a["s"])
    assert torch.equal(masked[0], a["theta"])
    assert torch.equal(masked[1], a["pmat"])
    assert masked[0].data_ptr() != a["theta"].data_ptr()
    assert masked[1].data_ptr() != a["pmat"].data_ptr()
    one = rff_krls_bank_chunk_cuda(a["theta"], a["pmat"],
                                   a["xs"][:, :1].contiguous(),
                                   a["ys"][:, :1].contiguous(), *common, None,
                                   a["s"])
    step = rff_krls_bank_step_cuda(a["theta"], a["pmat"],
                                   a["xs"][:, 0].contiguous(),
                                   a["ys"][:, 0].contiguous(), *common,
                                   a["s"])
    assert all(torch.equal(u.reshape(v.shape), v) for u, v in zip(one, step))


@pytest.mark.cuda
def test_compact_workspace_matches_c_layout(cuda_device, monkeypatch):
    """The C entry's workspace bytes and Tc are those chunking.py mirrors;
    a workspace a byte short is refused (cudaErrorInvalidValue); tenants
    taken in slabs of two give the same bits as one slab."""
    from repro_torch.kernels import chunking, rff_krls_step

    lib = rff_krls_step._compact_lib()
    assert lib.krls_compact_tc() == chunking.KRLS_COMPACT_TC
    for shape in ((1, 16, 5, 400), (583, 16, 5, 1024), (7, 3, 128, 1031)):
        assert lib.krls_compact_workspace_bytes(*shape) == \
            chunking.krls_compact_workspace_bytes(*shape)
    a = _krls_inputs(cuda_device, 5, 19, 5, 337, seed=11, symmetric=False)
    args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
            a["beta"], a["mask"], a["s"])
    want = rff_krls_step.rff_krls_bank_chunk_cuda(*args)
    outs = [torch.empty_like(t) for t in want]
    nbytes = chunking.krls_compact_workspace_bytes(5, 16, 5, 337)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=cuda_device)
    code = lib.krls_bank_chunk_compact(
        *(t.data_ptr() for t in (a["theta"], a["pmat"], a["xs"], a["ys"],
                                 a["mask"], a["beta"], a["w"], a["b"],
                                 a["s"], *outs)),
        5, 19, 5, 337, torch.cuda.current_stream().cuda_stream,
        ws.data_ptr(), nbytes - 1, 5)
    torch.cuda.synchronize()
    assert code == 1  # cudaErrorInvalidValue
    monkeypatch.setattr(rff_krls_step, "krls_compact_slab",
                        lambda *shape: 2)
    slabs = rff_krls_step.rff_krls_bank_chunk_cuda(*args)
    assert all(torch.equal(u, v) for u, v in zip(slabs, want))


@pytest.mark.cuda
def test_krls_resident_smem_matches_c_layout(cuda_device):
    """The resident C entry carves the layout chunking.krls_resident_fits
    mirrors: at d = 5 it launches at D = 335 and refuses D = 336 with
    cudaErrorInvalidValue, where the wrapper takes the compact route."""
    from repro_torch.kernels.rff_krls_step import _lib

    codes = {}
    for dfeat in (335, 336):
        a = _krls_inputs(cuda_device, 1, 2, 5, dfeat)
        outs = (torch.empty_like(a["theta"]), torch.empty_like(a["pmat"]),
                torch.empty_like(a["ys"]), torch.empty_like(a["ys"]))
        codes[dfeat] = _lib().krls_bank_chunk_resident(
            *(t.data_ptr() for t in (a["theta"], a["pmat"], a["xs"], a["ys"])),
            None, a["beta"].data_ptr(),
            *(t.data_ptr() for t in (a["w"], a["b"], a["s"], *outs)),
            1, 2, 5, dfeat, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    assert codes == {335: 0, 336: 1}  # 1 = cudaErrorInvalidValue


@pytest.mark.cuda
def test_krls_wrappers_refuse_bad_inputs(cuda_device):
    a = _krls_inputs(cuda_device, 3, 2, 4, 16)
    args = (a["xs"], a["ys"], a["w"], a["b"], 0.99)
    with pytest.raises(ValueError, match="contiguous"):
        rff_krls_bank_chunk_cuda(a["theta"], a["pmat"].transpose(1, 2),
                                 *args)
    with pytest.raises(TypeError, match="float32"):
        rff_krls_bank_chunk_cuda(a["theta"], a["pmat"].double(), *args)
    with pytest.raises(ValueError, match="shape"):
        rff_krls_bank_step_cuda(a["theta"], a["pmat"][:, :8], a["xs"][:, 0],
                                a["ys"][:, 0], a["w"], a["b"], 0.99)
    with pytest.raises(ValueError, match="shared memory"):
        big = 12_000
        rff_krls_bank_step_cuda(
            torch.zeros(1, big, device=cuda_device),
            torch.zeros(1, 1, 1, device=cuda_device), a["xs"][:1, 0],
            a["ys"][:1, 0], torch.zeros(4, big, device=cuda_device),
            torch.zeros(big, device=cuda_device), 0.99)


@pytest.mark.cuda
def test_krls_server_runs_through_the_kernels(cuda_device):
    """make_server("krls") on the card: every flush launches the chunk
    kernel, make_tick the step kernel, and both agree with mode="ref"."""
    fm = rff_map(torch.Generator().manual_seed(0), 5, 120, 2.0,
                 device=cuda_device)
    hp = dict(lam=1e-2, beta=0.999, chunk=4)
    srv = make_server("krls", feature_map=fm, bank=16, **hp)
    ref = make_server("krls", feature_map=fm, bank=16, mode="ref", **hp)
    chunks = rff_krls_bank_chunk_cuda.launches
    rng = np.random.default_rng(2)
    for _ in range(160):
        tenant, x = int(rng.integers(0, 14)), rng.normal(size=5)
        y = 1.0 + np.sin(x[0])
        srv.submit(tenant, x, y)
        ref.submit(tenant, x, y)
    srv.drain()
    ref.drain()
    assert rff_krls_bank_chunk_cuda.launches > chunks
    got, want = srv.snapshot.state, ref.snapshot.state
    torch.testing.assert_close(got.theta, want.theta, atol=F32_TOL,
                               rtol=F32_TOL)
    _hold_p(got.pmat, want.pmat)
    xq = rng.normal(size=(16, 9, 5)).astype(np.float32)
    torch.testing.assert_close(srv.predict_block(xq), ref.predict_block(xq),
                               atol=F32_TOL, rtol=F32_TOL)
    steps = rff_krls_bank_step_cuda.launches
    x = torch.randn(16, 5, device=cuda_device)
    y = x[:, 0].contiguous()
    got = make_tick("krls", fm, beta=0.999)(got, x, y)
    want = make_tick("krls", fm, beta=0.999, mode="ref")(want, x, y)
    assert rff_krls_bank_step_cuda.launches == steps + 1
    torch.testing.assert_close(got[0].theta, want[0].theta, atol=F32_TOL,
                               rtol=F32_TOL)


FEAT_TOL, FEAT_BF16_TOL = 1e-5, 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,dfeat", [(1, 1, 17), (33, 5, 300),
                                       (256, 128, 2048), (1000, 70, 129)])
def test_features_kernel_matches_plain(cuda_device, m, d, dfeat):
    a = _inputs(cuda_device, 1, m, d, dfeat, seed=3)
    x = a["xs"][0]
    smax = float(a["s"].abs().max())
    launches = rff_features_cuda.launches
    for precision, tol in ((None, FEAT_TOL), ("bf16", FEAT_BF16_TOL)):
        got = ops.rff_features(x, a["w"], a["b"], a["s"], mode="cuda",
                               precision=precision)
        want = ops.rff_features(x, a["w"], a["b"], a["s"], mode="ref",
                                precision=precision)
        assert got.dtype == want.dtype and got.shape == (m, dfeat)
        assert float((got.float() - want.float()).abs().max()) <= tol * smax
    assert rff_features_cuda.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_feature_row_bits_do_not_depend_on_the_call(cuda_device, precision):
    """A row of x featurized alone, inside a 256-row call and inside a
    65536-row call gives the same bits, on every tile plan (128 rows of 8 x
    8 a thread, 32 rows of 4 x 4, and the plan's own)."""
    a = _inputs(cuda_device, 1, 65536, 128, 2048, seed=9)
    x = a["xs"][0]
    args = (a["w"], a["b"], a["s"], precision)
    row = 300
    want = rff_features_cuda(x[row:row + 1].contiguous(), *args)
    for rows in (None, 128, 32):
        for block in (x[256:512], x):
            got = rff_features_cuda(block.contiguous(), *args, _rows=rows)
            at = row - 256 if block.shape[0] == 256 else row
            assert torch.equal(got[at], want[0]), (rows, block.shape[0])
        del got


@pytest.mark.cuda
@pytest.mark.parametrize("tlen,d,dfeat,chunk,normalized,mu", [
    (64, 8, 256, None, False, 0.5), (37, 5, 300, 16, True, 0.5),
    (9, 3, 17, 1, False, 0.5), (100, 128, 513, 48, False, 0.5),
    (256, 128, 2048, None, False, 0.5), (256, 128, 2048, None, True, 0.5),
    (1024, 128, 2048, 512, False, 0.5), (256, 5, 300, None, False, 1.5),
])
def test_element_kernels_match_plain(cuda_device, tlen, d, dfeat, chunk,
                                     normalized, mu):
    a = _inputs(cuda_device, 1, tlen, d, dfeat, seed=4)
    xs, ys = a["xs"][0], a["ys"][0]
    common = (xs, ys, a["w"], a["b"])
    got = ops.rff_klms_chunk_elements(*common, mu, a["s"], mode="cuda",
                                      chunk=chunk, normalized=normalized)
    want = ops.rff_klms_chunk_elements(*common, mu, a["s"], mode="ref",
                                       chunk=chunk, normalized=normalized)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    got = ops.rff_krls_chunk_elements(*common, 0.99, a["s"], mode="cuda",
                                      chunk=chunk)
    want = ops.rff_krls_chunk_elements(*common, 0.99, a["s"], mode="ref",
                                       chunk=chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)


def _element_args(a, mu, dtype=torch.float32):
    return (a["xs"][0].to(dtype), a["ys"][0].to(dtype), a["w"].to(dtype),
            a["b"].to(dtype), mu, a["s"].to(dtype))


def _dist(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("normalized", [False, True])
def test_klms_elements_no_farther_from_float64_than_the_fold(cuda_device,
                                                             normalized):
    """Kernel 7 composes a chunk in closed form (compact WY), not by the
    fold: at the replay shape (T = 256, d = 128, D = 2048, mu = 0.5) its A
    and v are each within twice the f32 fold's own distance from a float64
    fold."""
    a = _inputs(cuda_device, 1, 256, 128, 2048, seed=6)
    kw = dict(normalized=normalized)
    exact = ops.rff_klms_chunk_elements(*_element_args(a, 0.5, torch.float64),
                                        mode="ref", **kw)
    plain = ops.rff_klms_chunk_elements(*_element_args(a, 0.5), mode="ref",
                                        **kw)
    got = ops.rff_klms_chunk_elements(*_element_args(a, 0.5), mode="cuda",
                                      **kw)
    for g, p, e in zip(got, plain, exact):
        assert _dist(g, e) <= 2.0 * _dist(p, e)


@pytest.mark.cuda
def test_klms_elements_stress_case(cuda_device):
    """d = 5, D = 300, mu = 1.5: T's entries grow past 2; v stays within
    1e-4 of max |v| of a float64 fold."""
    a = _inputs(cuda_device, 1, 256, 5, 300, seed=7)
    exact = ops.rff_klms_chunk_elements(*_element_args(a, 1.5, torch.float64),
                                        mode="ref")
    got = ops.rff_klms_chunk_elements(*_element_args(a, 1.5), mode="cuda")
    assert _dist(got[1], exact[1]) <= 1e-4 * float(exact[1].abs().max())
    assert _dist(got[0], exact[0]) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tlen,d,dfeat,beta", [(256, 5, 300, 0.9995),
                                               (256, 128, 2048, 0.99)])
def test_krls_elements_no_farther_from_float64_than_the_fold(
        cuda_device, tlen, d, dfeat, beta):
    """Kernel 8 forms a chunk as one weighted Gram, not by the fold: at the
    paper's replay shape and at the KLMS replay width its g, Phi and r are
    each within twice the f32 fold's own distance from a float64 fold."""
    a = _inputs(cuda_device, 1, tlen, d, dfeat, seed=10)
    exact = ops.rff_krls_chunk_elements(
        *_element_args(a, beta, torch.float64), mode="ref")
    plain = ops.rff_krls_chunk_elements(*_element_args(a, beta), mode="ref")
    got = ops.rff_krls_chunk_elements(*_element_args(a, beta), mode="cuda")
    for g, p, e in zip(got, plain, exact):
        assert _dist(g, e) <= 2.0 * _dist(p, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dfeat", [300, 2048, 129])
def test_krls_elements_bitwise_contracts(cuda_device, dfeat):
    """Two calls agree bit for bit; a chunk's element equals the same chunk
    launched alone; both product tiles (64, 32) and a workspace of
    one chunk at a time give the same bits; Phi equals Phi^T; the masked
    chunk is (1, 0, 0) and g is the fold's g."""
    from repro_torch.kernels import rff_scan

    a = _inputs(cuda_device, 1, 300, 6, dfeat, seed=11)
    xs = a["xs"][0].reshape(3, 100, 6)
    ys = a["ys"][0].reshape(3, 100)
    mask = a["mask"][0].reshape(3, 100).clone()
    mask[2] = 0
    args = (xs, ys, a["w"], a["b"], 0.999, mask, a["s"])
    first = rff_krls_chunk_elements_cuda(*args)
    again = rff_krls_chunk_elements_cuda(*args)
    assert all(torch.equal(u, w) for u, w in zip(first, again))
    for tile in (64, 32):
        forced = rff_krls_chunk_elements_cuda(*args, _tile=tile)
        assert all(torch.equal(u, w) for u, w in zip(first, forced)), tile
    alone = rff_krls_chunk_elements_cuda(
        xs[1:2].contiguous(), ys[1:2].contiguous(), a["w"], a["b"], 0.999,
        mask[1:2].contiguous(), a["s"])
    assert all(torch.equal(u[0], w[1]) for u, w in zip(alone, first))
    budget = rff_scan.ELEMENT_WORKSPACE_BUDGET
    try:
        rff_scan.ELEMENT_WORKSPACE_BUDGET = 1
        grouped = rff_krls_chunk_elements_cuda(*args)
    finally:
        rff_scan.ELEMENT_WORKSPACE_BUDGET = budget
    assert all(torch.equal(u, w) for u, w in zip(first, grouped))
    g, phi, r = first
    assert all(torch.equal(p, p.T) for p in phi)
    assert float(g[2]) == 1.0 and not bool(phi[2].any()) and not bool(
        r[2].any())
    fold = ops.rff_krls_chunk_elements(a["xs"][0][:200], a["ys"][0][:200],
                                       a["w"], a["b"], 0.999, a["s"],
                                       mode="ref", chunk=100)
    live = rff_krls_chunk_elements_cuda(xs[:2], ys[:2], a["w"], a["b"], 0.999,
                                        None, a["s"])
    assert torch.equal(live[0], fold[0])


@pytest.mark.cuda
def test_klms_elements_bitwise_contracts(cuda_device):
    """Two calls agree bit for bit; a chunk's element equals the same chunk
    launched alone; a call whose workspace holds one chunk at a time gives
    the same bits as one that holds all three."""
    from repro_torch.kernels import rff_scan

    a = _inputs(cuda_device, 1, 300, 6, 300, seed=8)
    xs = a["xs"][0].reshape(3, 100, 6)
    ys = a["ys"][0].reshape(3, 100)
    mask = a["mask"][0].reshape(3, 100)
    args = (xs, ys, a["w"], a["b"], 0.5, mask, a["s"])
    first = rff_klms_chunk_elements_cuda(*args, normalized=True)
    again = rff_klms_chunk_elements_cuda(*args, normalized=True)
    assert all(torch.equal(u, w) for u, w in zip(first, again))
    alone = rff_klms_chunk_elements_cuda(
        xs[1:2].contiguous(), ys[1:2].contiguous(), a["w"], a["b"], 0.5,
        mask[1:2].contiguous(), a["s"], normalized=True)
    assert torch.equal(alone[0][0], first[0][1])
    assert torch.equal(alone[1][0], first[1][1])
    budget = rff_scan.ELEMENT_WORKSPACE_BUDGET
    try:
        rff_scan.ELEMENT_WORKSPACE_BUDGET = 1
        grouped = rff_klms_chunk_elements_cuda(*args, normalized=True)
    finally:
        rff_scan.ELEMENT_WORKSPACE_BUDGET = budget
    assert all(torch.equal(u, w) for u, w in zip(first, grouped))


@pytest.mark.cuda
def test_klms_element_workspace(cuda_device):
    """The C entry sizes one chunk's workspace (1,843,200 floats at Tc =
    256, D = 2048: the padded Z and Y, the Gram's 16 partial slabs of 10
    lower tiles, G and [T | c]), 0 past Tc = 16384 or D = 2^22, and refuses
    a workspace one float short; an all-zero Z gives A = I."""
    from repro_torch.kernels.rff_scan import _lib

    lib = _lib()
    assert lib.klms_element_chunk_floats(256, 2048) == 1_843_200
    assert lib.klms_element_chunk_floats(16385, 17) == 0
    assert lib.klms_element_chunk_floats(8, (1 << 22) + 1) == 0
    ys = torch.zeros(8, device=cuda_device)
    z = torch.zeros(8, 17, device=cuda_device)
    out_a = torch.empty(1, 17, 17, device=cuda_device)
    out_v = torch.empty(1, 17, device=cuda_device)
    per = lib.klms_element_chunk_floats(8, 17)
    ws = torch.empty(per, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    codes = [lib.klms_chunk_elements(
        z.data_ptr(), ys.data_ptr(), None, out_a.data_ptr(),
        out_v.data_ptr(), ws.data_ptr(), n, 1, 8, 17, 0.5, 0, 1e-6, stream)
        for n in (per, per - 1)]
    torch.cuda.synchronize()
    assert codes == [0, 1]  # 1 = cudaErrorInvalidValue
    assert torch.equal(out_a[0], torch.eye(17, device=cuda_device))


@pytest.mark.cuda
def test_element_kernels_exact_contracts(cuda_device):
    """A fully masked chunk is the identity element bit for bit; a
    remainder chunk composes like the whole chunk."""
    a = _inputs(cuda_device, 1, 24, 6, 300, seed=5)
    xs = a["xs"][0].reshape(3, 8, 6)
    ys = a["ys"][0].reshape(3, 8)
    mask = torch.ones_like(ys)
    mask[1] = 0
    args = (xs, ys, a["w"], a["b"])
    av, vv = rff_klms_chunk_elements_cuda(*args, 0.5, mask, a["s"])
    assert torch.equal(av[1], torch.eye(300, device=cuda_device))
    assert torch.equal(vv[1], torch.zeros(300, device=cuda_device))
    g, phi, r = rff_krls_chunk_elements_cuda(*args, 0.99, mask, a["s"])
    assert float(g[1]) == 1.0
    assert not bool(phi[1].any()) and not bool(r[1].any())
    assert torch.equal(phi[0], phi[0].T)
    whole = ops.rff_klms_chunk_elements(a["xs"][0][:20], a["ys"][0][:20],
                                        a["w"], a["b"], 0.5, a["s"],
                                        mode="cuda", chunk=20)
    parts = ops.rff_klms_chunk_elements(a["xs"][0][:20], a["ys"][0][:20],
                                        a["w"], a["b"], 0.5, a["s"],
                                        mode="cuda", chunk=16)
    a2 = parts[0][1] @ parts[0][0]
    torch.testing.assert_close(a2, whole[0][0], atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
def test_replay_wrappers_refuse_bad_inputs(cuda_device):
    a = _inputs(cuda_device, 2, 4, 3, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rff_features_cuda(a["xs"][0].cpu(), a["w"], a["b"])
    with pytest.raises(ValueError, match=r"\(M, d\)"):
        rff_features_cuda(a["xs"], a["w"], a["b"])
    with pytest.raises(TypeError, match="float32"):
        rff_features_cuda(a["xs"][0].double(), a["w"], a["b"])
    with pytest.raises(ValueError, match="contiguous"):
        rff_klms_chunk_elements_cuda(a["xs"].transpose(0, 1), a["ys"].T,
                                     a["w"], a["b"], 0.5)
    with pytest.raises(ValueError, match="shape"):
        rff_krls_chunk_elements_cuda(a["xs"], a["ys"][:, :2], a["w"],
                                     a["b"], 0.99)
    with pytest.raises(ValueError, match="shape"):
        rff_klms_chunk_elements_cuda(a["xs"], a["ys"], a["w"], a["b"][:8],
                                     0.5)
    with pytest.raises(ValueError, match="Tc <= 16384"):
        rff_klms_chunk_elements_cuda(
            torch.zeros(1, 16385, 3, device=cuda_device),
            torch.zeros(1, 16385, device=cuda_device), a["w"], a["b"], 0.5)
    with pytest.raises(ValueError, match="Tc <= 16384"):
        rff_krls_chunk_elements_cuda(
            torch.zeros(1, 16385, 3, device=cuda_device),
            torch.zeros(1, 16385, device=cuda_device), a["w"], a["b"], 0.99)
    with pytest.raises(ValueError, match="_tile"):
        rff_krls_chunk_elements_cuda(a["xs"], a["ys"], a["w"], a["b"], 0.99,
                                     _tile=16)
    with pytest.raises(ValueError, match="_rows"):
        rff_features_cuda(a["xs"][0], a["w"], a["b"], _rows=16)


@pytest.mark.cuda
@pytest.mark.parametrize("rebuild_mode", ["blocked", "scan"])
def test_klms_evict_readmit_runs_through_the_kernels(cuda_device,
                                                     rebuild_mode):
    """make_server("klms", log_capacity=...) on the card: readmit replays
    the log through the feature kernel (and the element kernel when
    blocked) and agrees with the same server in mode="ref"."""
    fm = rff_map(torch.Generator().manual_seed(1), 6, 256, 2.0,
                 device=cuda_device)
    kw = dict(bank=8, chunk=8, mu=0.4, log_capacity=64,
              rebuild_mode=rebuild_mode)
    srv = make_server("klms", feature_map=fm, **kw)
    ref = make_server("klms", feature_map=fm, mode="ref", **kw)
    rng = np.random.default_rng(6)
    obs = [(int(rng.integers(0, 8)), rng.normal(size=6), float(rng.normal()))
           for _ in range(200)]
    for s in (srv, ref):
        for t, x, y in obs[:120]:
            s.submit(t, x, y)
        s.drain()
        s.evict(3)
        for t, x, y in obs[120:]:
            s.submit(t, x, y)
        s.drain()
    feats = rff_features_cuda.launches
    elems = rff_klms_chunk_elements_cuda.launches
    n3 = sum(1 for t, _, _ in obs if t == 3)
    assert srv.readmit(3) == n3 and ref.readmit(3) == n3
    assert rff_features_cuda.launches > feats
    assert (rff_klms_chunk_elements_cuda.launches > elems) == (
        rebuild_mode == "blocked")
    torch.testing.assert_close(srv.snapshot.state.theta,
                               ref.snapshot.state.theta, atol=F32_TOL,
                               rtol=F32_TOL)
    xq = rng.normal(size=(8, 5, 6)).astype(np.float32)
    torch.testing.assert_close(srv.predict_block(xq), ref.predict_block(xq),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# The LM slice: decode block, chunked linear attention, flash attention
# ---------------------------------------------------------------------------


def _hold_rel(got, want, rel, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), what
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel} * {scale:.3g}"


def _decode_args(device, bh, tlen, dh, dfeat, dv, kind, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, positive=False):
        a = scale * rng.normal(size=shape)
        return convert.tensor(np.abs(a) if positive else a, device=device,
                              dtype=torch.float32)

    from repro_torch.kernels.ref import default_decode_scale

    return (t(bh, dfeat, dv, scale=0.1, positive=True),
            t(bh, dfeat, scale=0.1, positive=True) + 0.1,
            t(bh, tlen, dh, scale=dh ** -0.25),
            t(bh, tlen, dh, scale=dh ** -0.25), t(bh, tlen, dv),
            t(dh, dfeat), t(dfeat), default_decode_scale(dfeat, kind, device))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("kind", ["prf", "trig"])
@pytest.mark.parametrize("bh,tlen,dh,dfeat,dv,block_t", [
    (3, 5, 16, 40, 24, None),    # padded shapes
    (8, 1, 64, 256, 64, None),   # qwen2-0.5b's head, one token
    (4, 3, 128, 256, 128, None),  # llama3-8b's head width
    (5, 7, 16, 32, 16, 4),       # a full block and an unpadded remainder
])
def test_decode_block_kernel_matches_plain(cuda_device, kind, precision, bh,
                                           tlen, dh, dfeat, dv, block_t):
    args = _decode_args(cuda_device, bh, tlen, dh, dfeat, dv, kind)
    kw = dict(feature_kind=kind, normalize=kind == "prf",
              precision=precision, block_t=block_t)
    got = ops.rff_attention_decode_block(*args, mode="cuda", **kw)
    want = ops.rff_attention_decode_block(*args, mode="ref", **kw)
    rel = 2e-2 if precision else F32_TOL
    for g, w, what in zip(got, want, ("out", "S", "z")):
        _hold_rel(g, w, rel, f"{kind} {precision} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prf", "trig"])
def test_decode_block_equals_one_token_launches(cuda_device, kind):
    """A block of T tokens equals T launches of one, bit for bit."""
    from repro_torch.kernels.rff_attention import (
        rff_attention_decode_block_cuda,
    )

    sm, zv, q, k, v, w, b, s = _decode_args(cuda_device, 6, 9, 64, 256, 64,
                                            kind, seed=1)
    kw = dict(feature_kind=kind, normalize=kind == "prf")
    n = rff_attention_decode_block_cuda.launches
    blk = ops.rff_attention_decode_block(sm, zv, q, k, v, w, b, s,
                                         mode="cuda", **kw)
    assert rff_attention_decode_block_cuda.launches == n + 1
    outs = []
    for i in range(9):
        o, sm, zv = ops.rff_attention_decode_block(
            sm, zv, q[:, i:i + 1].contiguous(), k[:, i:i + 1].contiguous(),
            v[:, i:i + 1].contiguous(), w, b, s, mode="cuda", **kw)
        outs.append(o)
    assert torch.equal(blk[0], torch.cat(outs, 1))
    assert torch.equal(blk[1], sm) and torch.equal(blk[2], zv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prf", "trig"])
@pytest.mark.parametrize("bh,tlen,dh,dfeat,dv", [
    (4, 7, 128, 256, 128),  # llama3-8b's head
    (3, 9, 16, 40, 24),     # padded shapes
])
def test_decode_block_equals_one_token_launches_at_more_heads(
        cuda_device, kind, bh, tlen, dh, dfeat, dv):
    """A block of T tokens equals T launches of one, bit for bit."""
    sm, zv, q, k, v, w, b, s = _decode_args(cuda_device, bh, tlen, dh, dfeat,
                                            dv, kind, seed=2)
    kw = dict(feature_kind=kind, normalize=kind == "prf")
    blk = ops.rff_attention_decode_block(sm, zv, q, k, v, w, b, s,
                                         mode="cuda", **kw)
    outs = []
    for i in range(tlen):
        o, sm, zv = ops.rff_attention_decode_block(
            sm, zv, q[:, i:i + 1].contiguous(), k[:, i:i + 1].contiguous(),
            v[:, i:i + 1].contiguous(), w, b, s, mode="cuda", **kw)
        outs.append(o)
    assert torch.equal(blk[0], torch.cat(outs, 1))
    assert torch.equal(blk[1], sm) and torch.equal(blk[2], zv)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("kind", ["prf", "trig"])
@pytest.mark.parametrize("tlen", [1, 4])
def test_decode_block_kernel_matches_plain_at_odd_widths(cuda_device, kind,
                                                         precision, tlen):
    """dh, D and dv not multiples of 4 (scalar copies of S, W and the
    tokens; W staged when T > 1)."""
    args = _decode_args(cuda_device, 3, tlen, 7, 17, 5, kind, seed=4)
    kw = dict(feature_kind=kind, normalize=kind == "prf",
              precision=precision)
    got = ops.rff_attention_decode_block(*args, mode="cuda", **kw)
    want = ops.rff_attention_decode_block(*args, mode="ref", **kw)
    rel = 2e-2 if precision else F32_TOL
    for g, w, what in zip(got, want, ("out", "S", "z")):
        _hold_rel(g, w, rel, f"{kind} {precision} T={tlen} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("kind", ["prf", "trig"])
@pytest.mark.parametrize("tlen", [1, 6])
def test_decode_block_column_tiles_agree(cuda_device, kind, precision, tlen):
    """The first dv tile's outputs and state equal a call on those columns
    of S and v, and z is the same."""
    from repro_torch.kernels.chunking import DECODE_TILE_COLS as tile

    sm, zv, q, k, v, w, b, s = _decode_args(cuda_device, 5, tlen, 64, 256,
                                            80, kind, seed=3)
    kw = dict(feature_kind=kind, normalize=kind == "prf",
              precision=precision, mode="cuda")
    full = ops.rff_attention_decode_block(sm, zv, q, k, v, w, b, s, **kw)
    first = ops.rff_attention_decode_block(
        sm[..., :tile].contiguous(), zv, q, k, v[..., :tile].contiguous(), w,
        b, s, **kw)
    assert torch.equal(full[0][..., :tile], first[0])
    assert torch.equal(full[1][..., :tile], first[1])
    assert torch.equal(full[2], first[2])


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("bh,slen,dfeat,dv,chunk", [
    (3, 64, 32, 16, 16), (2, 192, 40, 24, 64), (2, 512, 256, 64, 256),
    (1, 256, 256, 128, 256),
])
def test_linear_attention_kernel_matches_plain(cuda_device, normalize, bh,
                                               slen, dfeat, dv, chunk):
    rng = np.random.default_rng(slen)

    def t(*shape, positive=False):
        a = rng.normal(size=shape)
        if positive:
            a = np.log1p(np.exp(a)) + 0.01
        return convert.tensor(a, device=cuda_device, dtype=torch.float32)

    q, k, v = (t(bh, slen, dfeat, positive=True),
               t(bh, slen, dfeat, positive=True), t(bh, slen, dv))
    got = ops.rff_attention(q, k, v, mode="cuda", chunk=chunk,
                            normalize=normalize)
    want = ops.rff_attention(q, k, v, mode="ref", chunk=chunk,
                             normalize=normalize)
    _hold_rel(got, want, F32_TOL, "linear attention")


def _linear_args(device, bh, slen, dfeat, dv, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, positive=False):
        a = rng.normal(size=shape)
        if positive:
            a = np.log1p(np.exp(a)) + 0.01
        return convert.tensor(a, device=device, dtype=torch.float32)

    return (t(bh, slen, dfeat, positive=True),
            t(bh, slen, dfeat, positive=True), t(bh, slen, dv))


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("bh,slen,dfeat,dv,chunk", [
    (2, 4096, 256, 64, 256),  # many chunks (64 of the kernels' 64 rows)
    (2, 100, 40, 24, 256),    # S not a multiple of 64; min(chunk, S) = 100
    (2, 256, 256, 128, 64),   # two dv tiles
    (2, 192, 64, 200, 64),    # a ragged last dv tile
    (2, 70, 17, 5, 70),       # D and dv not multiples of 4: scalar copies
])
def test_linear_attention_kernel_matches_plain_at_more_shapes(
        cuda_device, normalize, bh, slen, dfeat, dv, chunk):
    q, k, v = _linear_args(cuda_device, bh, slen, dfeat, dv, seed=dv)
    got = ops.rff_attention(q, k, v, mode="cuda", chunk=chunk,
                            normalize=normalize)
    want = ops.rff_attention(q, k, v, mode="ref", chunk=chunk,
                             normalize=normalize)
    _hold_rel(got, want, F32_TOL, f"linear attention {bh, slen, dfeat, dv}")


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("bh,slen,dfeat,dv", [(2, 256, 256, 128),
                                              (3, 100, 40, 200)])
def test_linear_attention_column_tiles_and_reruns_agree(
        cuda_device, normalize, bh, slen, dfeat, dv):
    """The first dv tile's columns equal a call on those columns of v, and
    two launches give the same bits (no atomics)."""
    from repro_torch.kernels.chunking import LINEAR_TILE_COLS as tile
    from repro_torch.kernels.rff_attention import rff_attention_cuda

    q, k, v = _linear_args(cuda_device, bh, slen, dfeat, dv, seed=7)
    kw = dict(chunk=slen, normalize=normalize)
    n = rff_attention_cuda.launches
    full = rff_attention_cuda(q, k, v, **kw)
    again = rff_attention_cuda(q, k, v, **kw)
    first = rff_attention_cuda(q, k, v[..., :tile].contiguous(), **kw)
    assert rff_attention_cuda.launches == n + 3
    assert torch.equal(full, again)
    assert torch.equal(full[..., :tile], first)


@pytest.mark.cuda
def test_linear_attention_workspace_matches_c_layout(cuda_device):
    """The wrapper's workspace plan is the kernels' own size."""
    from repro_torch.kernels import chunking
    from repro_torch.kernels.rff_attention import smem_bytes

    sizes = smem_bytes()
    assert sizes["workspace_lm"] == chunking.linear_attention_plan(
        56, 2048, 256, 64).workspace_bytes
    assert sizes["workspace_ragged"] == chunking.linear_attention_plan(
        3, 100, 40, 200).workspace_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,slen,dh", [(3, 128, 16), (2, 100, 24),
                                        (4, 256, 64), (2, 192, 128),
                                        (2, 77, 20), (2, 130, 40)])
def test_flash_kernel_matches_plain(cuda_device, dtype, causal, bh, slen, dh):
    rng = np.random.default_rng(dh)
    q, k, v = (convert.tensor(rng.normal(size=(bh, slen, dh)),
                              device=cuda_device, dtype=dtype)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, mode="cuda", causal=causal)
    want = ops.flash_attention(q, k, v, mode="ref", causal=causal)
    assert got.dtype == dtype
    _hold_rel(got, want, 2e-2 if dtype == torch.bfloat16 else F32_TOL,
              f"flash {dtype} causal={causal}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,slen,dh,dv", [
    (4, 256, 192, 128),  # deepseek-v2-lite's MLA head
    (3, 200, 96, 64),    # minicpm3's
    (2, 192, 256, 256),  # recurrentgemma's: two V passes on the bf16 route
])
def test_flash_kernel_takes_every_config_head(cuda_device, dtype, causal, bh,
                                              slen, dh, dv):
    """q/k and v heads of different widths up to 256 on both routes, each
    bf16 V pass counted as a launch."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_plan,
    )

    rng = np.random.default_rng(dh + dv)
    q, k = (convert.tensor(rng.normal(size=(bh, slen, dh)),
                           device=cuda_device, dtype=dtype) for _ in range(2))
    v = convert.tensor(rng.normal(size=(bh, slen, dv)), device=cuda_device,
                       dtype=dtype)
    n = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, mode="cuda", causal=causal)
    assert flash_attention_cuda.launches == n + len(flash_plan(q, k, v).passes)
    want = ops.flash_attention(q, k, v, mode="ref", causal=causal)
    assert got.dtype == dtype and got.shape == (bh, slen, dv)
    _hold_rel(got, want, 2e-2 if dtype == torch.bfloat16 else F32_TOL,
              f"flash {dtype} ({dh}, {dv}) causal={causal}")


@pytest.mark.cuda
def test_flash_routes_count_their_launches(cuda_device):
    """bf16 runs the tensor-core kernel and f32 the CUDA-core one; each
    launch counts once in the total and once in its route."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    x = torch.randn(2, 64, 32, device=cuda_device)
    for dtype, route in ((torch.bfloat16, "tensor_core"),
                         (torch.float32, "cuda_core")):
        before = dict(flash_attention_cuda.route_launches)
        total = flash_attention_cuda.launches
        ops.flash_attention(*(x.to(dtype),) * 3, mode="cuda")
        assert flash_attention_cuda.launches == total + 1
        assert flash_attention_cuda.route_launches[route] == before[route] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,slen,dh,dv", [
    (2, 127, 64, 64), (2, 128, 64, 64), (2, 129, 64, 64),  # a 128-row tile
    (1, 2049, 64, 64),   # one row past the last full tile
    (32, 64, 16, 16),    # the launcher's reduced qwen2: one 64-row tile
    (2, 70, 6, 10),      # widths padded to 4
])
def test_flash_f32_tile_edges(cuda_device, causal, bh, slen, dh, dv):
    """The f32 route at the edges of its query and key tiles, at F32_TOL
    of max|plain|."""
    rng = np.random.default_rng(slen + dh)
    q, k = (convert.tensor(rng.normal(size=(bh, slen, dh)),
                           device=cuda_device, dtype=torch.float32)
            for _ in range(2))
    v = convert.tensor(rng.normal(size=(bh, slen, dv)), device=cuda_device,
                       dtype=torch.float32)
    got = ops.flash_attention(q, k, v, mode="cuda", causal=causal)
    want = ops.flash_attention(q, k, v, mode="ref", causal=causal)
    assert got.shape == (bh, slen, dv)
    _hold_rel(got, want, F32_TOL, f"flash f32 {bh, slen, dh, dv} "
              f"causal={causal}")


def _flash_f32_at_tile(q, k, v, causal, tile):
    """The f32 flash kernel's C entry at a (query rows, rows a thread)
    tile, widths multiples of 4: its return code and its output."""
    from repro_torch.kernels.flash_attention import _lib

    bh, slen, dh = q.shape
    out = torch.empty_like(v)
    code = _lib("cuda_core").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, slen,
        dh, v.shape[-1], int(causal), dh ** -0.5, *tile,
        torch.cuda.current_stream(q.device).cuda_stream)
    return code, out


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,slen,dh,dv", [(6, 300, 64, 64),
                                          (4, 200, 192, 128),
                                          (3, 130, 256, 256)])
def test_flash_f32_bitwise_contracts(cuda_device, causal, bh, slen, dh, dv):
    """The f32 route's bits: two calls agree; a head's output does not
    depend on BH (a call on a subset of heads equals those heads of the
    full call); nor on the query tile (every tile that fits gives the same
    bits: each score sums over d in order, each output over keys in order,
    and the key tile's lanes do not change)."""
    from repro_torch.kernels.flash_attention import (
        CUDA_CORE_KEYS,
        CUDA_CORE_TILES,
        _smem_bytes,
        flash_attention_cuda,
        flash_plan,
    )
    from repro_torch.kernels.chunking import SMEM_BUDGET

    rng = np.random.default_rng(bh + dh)
    q, k = (convert.tensor(rng.normal(size=(bh, slen, dh)),
                           device=cuda_device, dtype=torch.float32)
            for _ in range(2))
    v = convert.tensor(rng.normal(size=(bh, slen, dv)), device=cuda_device,
                       dtype=torch.float32)
    full = flash_attention_cuda(q, k, v, causal=causal)
    assert torch.equal(full, flash_attention_cuda(q, k, v, causal=causal))
    heads = [bh - 1, 0] if bh > 1 else [0]
    sub = flash_attention_cuda(*(t[heads].contiguous() for t in (q, k, v)),
                               causal=causal)
    assert torch.equal(sub, full[heads])
    plan = flash_plan(q, k, v)
    tiles = [tile for tile, cap in CUDA_CORE_TILES.items()
             if dv <= cap and _smem_bytes("cuda_core", plan.width,
                                          plan.v_width, CUDA_CORE_KEYS,
                                          tile[0]) <= SMEM_BUDGET]
    assert (plan.query_tile, plan.thread_rows) in tiles
    assert len(tiles) >= (1 if dv > 128 else 2)
    for tile in tiles:
        code, out = _flash_f32_at_tile(q, k, v, causal, tile)
        assert code == 0 and torch.equal(full, out), tile


@pytest.mark.cuda
def test_flash_f32_smem_matches_c_layout_and_refusals(cuda_device,
                                                      monkeypatch):
    """_smem_bytes mirrors the CUDA-core kernel's own layout byte for byte
    at every tile; a tile the kernel cannot take raises through the
    wrapper, with no launch counted and no fallback, and its C entry
    returns an error for a tile over the budget or of no such shape."""
    from repro_torch.kernels.flash_attention import (
        CUDA_CORE_KEYS,
        _smem_bytes,
        cuda_core_smem_bytes,
        flash_attention_cuda,
    )

    # The module (the package's attribute flash_attention is the op).
    module = sys.modules["repro_torch.kernels.flash_attention"]
    for width, v_width in ((64, 64), (192, 128), (256, 256), (16, 16),
                           (20, 24), (96, 64)):
        for rows in (64, 128, 256):
            assert cuda_core_smem_bytes(rows, width, v_width) == \
                _smem_bytes("cuda_core", width, v_width, CUDA_CORE_KEYS, rows)
    x = torch.randn(2, 300, 128, device=cuda_device)
    n = flash_attention_cuda.launches
    with monkeypatch.context() as m:
        m.setattr(module, "_cuda_core_tile", lambda *_: (128, 8))
        with pytest.raises(RuntimeError, match="cudaError"):
            flash_attention_cuda(x, x, x)  # dv 128 > the tile's 64
    assert flash_attention_cuda.launches == n
    assert _flash_f32_at_tile(x, x, x, True, (256, 8))[0] != 0  # no such
    wide = torch.randn(2, 300, 256, device=cuda_device)
    assert _flash_f32_at_tile(wide, wide, x, True, (128, 4))[0] != 0  # budget
    # The refusals leave no error behind: the route still runs.
    _hold_rel(flash_attention_cuda(x, x, x),
              ops.flash_attention(x, x, x, mode="ref"), F32_TOL,
              "flash f32 after the refusals")


@pytest.mark.cuda
def test_attention_kernels_smem_and_refusals(cuda_device):
    from repro_torch.kernels import chunking
    from repro_torch.kernels.rff_attention import smem_bytes

    sizes = smem_bytes()
    assert sizes["decode_64"] == chunking.decode_smem_bytes(256, 64, 64)
    assert sizes["decode_128"] == chunking.decode_smem_bytes(256, 128, 128)
    assert sizes["linear_256"] == chunking.linear_attention_smem_bytes(256)
    x = torch.ones(2, 64, 16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        ops.rff_attention(x[:, :40], x[:, :40], x[:, :40], mode="cuda",
                          chunk=16)
    with pytest.raises(TypeError):
        ops.flash_attention(x, x, x.to(torch.bfloat16), mode="cuda")
    with pytest.raises(ValueError, match="head dim"):
        big = torch.ones(1, 8, 264, device=cuda_device)
        ops.flash_attention(big, big, big, mode="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        sm = torch.zeros(1, 1024, 128, device=cuda_device)
        zv = torch.zeros(1, 1024, device=cuda_device)
        tok = torch.zeros(1, 1, 128, device=cuda_device)
        ops.rff_attention_decode_block(
            sm, zv, tok, tok, tok, torch.zeros(128, 1024, device=cuda_device),
            torch.zeros(1024, device=cuda_device), mode="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["rff", "gqa"])
def test_lm_runs_through_the_attention_kernels(cuda_device, attn):
    """Reduced qwen2-0.5b on the card: decode steps (rff: the decode-block
    kernel) and a prefill step (rff: the linear-attention kernel; gqa: the
    flash kernel) against kernel_mode="ref"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rff_attention import (
        rff_attention_cuda,
        rff_attention_decode_block_cuda,
    )
    from repro_torch.models import transformer
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config("qwen2-0.5b").reduced()
    if attn == "rff":
        cfg = transformer.with_rff_attention(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = transformer.init_params(gen, cfg, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device=cuda_device)
    counts = (rff_attention_decode_block_cuda.launches,
              rff_attention_cuda.launches, flash_attention_cuda.launches)
    state = transformer.decode_state_init(cfg, 2, 16, device=cuda_device)
    ref_state = transformer.decode_state_init(cfg, 2, 16, device=cuda_device)
    for i in range(6):
        got, state = transformer.decode_step(params, cfg, state, toks[:, i])
        want, ref_state = transformer.decode_step(params, cfg, ref_state,
                                                  toks[:, i],
                                                  kernel_mode="ref")
        _hold_rel(got[:, :cfg.vocab_size], want[:, :cfg.vocab_size], 1e-4,
                  f"decode step {i}")
    got = make_prefill_step(cfg)(params, {"tokens": toks})
    want = make_prefill_step(cfg, kernel_mode="ref")(params, {"tokens": toks})
    _hold_rel(got, want, 1e-4, "prefill")
    after = (rff_attention_decode_block_cuda.launches,
             rff_attention_cuda.launches, flash_attention_cuda.launches)
    if attn == "rff":
        assert after[0] == counts[0] + 6 * cfg.num_layers
        assert after[1] == counts[1] + cfg.num_layers
    else:
        assert after[2] == counts[2] + cfg.num_layers


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["nklms", "qklms", "ald"])
def test_learner_servers_on_card(cuda_device, learner):
    """The baselines and NKLMS served on the card: a ragged stream, reads
    and a sequential readmit against the same server with mode="ref" (NKLMS
    reads through the read kernel; the dictionary learners run the same
    plain PyTorch on both)."""
    rng = np.random.default_rng(0)
    bank, d = 16, 5
    hp = {"nklms": dict(mu=0.5), "qklms": dict(sigma=5.0, mu=1.0,
                                               quant_eps=5.0, capacity=64),
          "ald": dict(sigma=5.0, nu=5e-3, capacity=64)}[learner]
    kw = dict(bank=bank, chunk=4, device=cuda_device, log_capacity=64,
              rebuild_mode="sequential", input_dim=d, **hp)
    if learner == "nklms":
        kw["feature_map"] = rff_map(torch.Generator().manual_seed(0), d, 96,
                                    2.0, device=cuda_device)
    srv = make_server(learner, **kw)
    ref = make_server(learner, mode="ref", **kw)
    before = ops.rff_bank_predict_cuda.launches
    tenants = rng.integers(0, bank, 200)
    xs = rng.normal(size=(200, d)).astype(np.float32)
    ys = (xs[:, 0] + 0.1 * xs[:, 1] ** 2).astype(np.float32)
    for s in (srv, ref):
        for i in range(120):
            s.submit(int(tenants[i]), xs[i], float(ys[i]))
        s.drain()
        s.evict(2)
        for i in range(120, 200):
            s.submit(int(tenants[i]), xs[i], float(ys[i]))
        s.drain()
        s.readmit(2)
    for g, w in zip(srv.queue.state, ref.queue.state):
        if g.is_floating_point():
            torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert torch.equal(g, w)
    xq = torch.from_numpy(
        rng.normal(size=(bank, 3, d)).astype(np.float32)).to(cuda_device)
    torch.testing.assert_close(srv.predict_block(xq), ref.predict_block(xq),
                               atol=F32_TOL, rtol=F32_TOL)
    launched = ops.rff_bank_predict_cuda.launches > before
    assert launched == (learner == "nklms")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["klms", "krls"])
def test_paper_realizations_on_card(cuda_device, family):
    """A figure's RFF realizations through the chunk kernels against
    mode="ref" on the same realizations: the tail MSE within 1e-3; every
    prior error within 1e-4 of the largest (KLMS), or within twice the
    plain path's own distance from a float64 run (KRLS at lam = 1e-4)."""
    from repro_torch import paper
    from repro_torch.core.rff import sample_rff
    from repro_torch.data.synthetic import gen_nonlinear_wiener

    rff = sample_rff(torch.Generator().manual_seed(0), 5, 300, 5.0,
                     device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    xs, ys = gen_nonlinear_wiener(gen, num_samples=600, runs=64)
    run = (paper.klms_realizations if family == "klms"
           else paper.krls_realizations)
    kw = dict(mu=1.0) if family == "klms" else {}
    _, got = run(rff, xs, ys, mode="cuda", **kw)
    _, want = run(rff, xs, ys, mode="ref", **kw)
    tail = lambda e: float(torch.mean(torch.square(e[:, -100:])))
    assert abs(tail(got) - tail(want)) <= 1e-3 * tail(want)
    if family == "klms":
        assert paper._max_rel(got, want) <= 1e-4
    else:
        rff64 = type(rff)(*(a.double() for a in rff))
        _, exact = run(rff64, xs.double(), ys.double(), mode="ref")
        eps = paper._max_rel(want.double(), exact)
        assert paper._max_rel(got.double(), exact) <= 2.0 * eps + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("family,d,dfeat", [("qmc", 128, 2048),
                                            ("gq", 5, 300), ("qmc", 5, 300)])
def test_deterministic_families_through_the_kernels(cuda_device, family, d,
                                                    dfeat):
    """qmc and gq maps (gq's scales are not uniform) through the KLMS chunk
    (kernel 1), the read (kernel 3) and the KRLS chunk (kernel 4) against
    their plain versions; the map built on the card is the CPU's bit for
    bit."""
    from repro_torch.features import make_feature_map

    sigma = float(np.sqrt(d))
    fm = make_feature_map(family, d, dfeat, sigma, device=cuda_device)
    host = make_feature_map(family, d, dfeat, sigma, device="cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(fm.trig, host.trig))
    tf = fm.trig
    a = _krls_inputs(cuda_device, 16, 6, d, dfeat, seed=3)
    args = (a["theta"], a["xs"], a["ys"], tf.omega, tf.bias, a["mu"],
            a["mask"], tf.scale)
    for g, w in zip(ops.rff_klms_bank_chunk(*args, mode="cuda"),
                    ops.rff_klms_bank_chunk(*args, mode="ref")):
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    for precision, tol in ((None, F32_TOL), ("bf16", BF16_TOL)):
        pargs = (a["theta"], a["xs"], tf.omega, tf.bias, tf.scale)
        torch.testing.assert_close(
            ops.rff_bank_predict(*pargs, mode="cuda", precision=precision),
            ops.rff_bank_predict(*pargs, mode="ref", precision=precision),
            atol=tol, rtol=tol)
    if dfeat <= 1024:
        kargs = (a["theta"], a["pmat"], a["xs"], a["ys"], tf.omega, tf.bias,
                 a["beta"], a["mask"], tf.scale)
        _hold_krls(ops.rff_krls_bank_chunk(*kargs, mode="cuda"),
                   ops.rff_krls_bank_chunk(*kargs, mode="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lru", "cost"])
def test_policy_server_kernel_matches_plain(cuda_device, policy):
    """A small policy server through the kernels (flushes, reads, blocked
    installs through kernels 6 and 7) against the same server with
    mode="ref": the same decisions, states within the served-stream
    bound."""
    fm = rff_map(torch.Generator().manual_seed(0), 8, 256, 3.0,
                 device=cuda_device)
    kw = dict(feature_map=fm, bank=16, chunk=8, policy=policy,
              log_capacity=64, rebuild_mode="blocked", size_watermark=8,
              device=cuda_device)
    srv, ref_srv = make_server("klms", **kw), make_server("klms", mode="ref",
                                                          **kw)
    rng = np.random.default_rng(4)
    probs = np.arange(1, 65, dtype=np.float64) ** -0.9
    ids = rng.choice(64, size=1200, p=probs / probs.sum())
    xs = rng.normal(size=(1200, 8)).astype(np.float32)
    reads = [[], []]
    for i, tenant in enumerate(ids.tolist()):
        for out, s in zip(reads, (srv, ref_srv)):
            if i % 4 == 3:
                out.append(s.predict(tenant, xs[i]))
            else:
                s.submit(tenant, xs[i], float(np.sin(xs[i, 0])))
    for s in (srv, ref_srv):
        s.drain()
    counters = srv.metrics.snapshot()["counters"]
    assert counters == ref_srv.metrics.snapshot()["counters"]
    assert counters["readmissions"] > 0 and srv.resident == ref_srv.resident
    torch.testing.assert_close(torch.stack(reads[0]), torch.stack(reads[1]),
                               atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(srv.queue.state.theta,
                               ref_srv.queue.state.theta, atol=F32_TOL,
                               rtol=F32_TOL)


def _obs_traffic(n, d, tenants, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, tenants)),
             rng.normal(size=d).astype(np.float32), float(rng.normal()))
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_traced_probed_server_is_bitwise_untraced_on_card(cuda_device,
                                                          learner, tmp_path):
    """trace, probe, recovery and a WAL change no bit of the state or the
    reads on the card, and obs.telemetry's kernel.launches equals each
    wrapper's .launches rise."""
    from repro_torch.obs import telemetry

    d, dfeat = (16, 256) if learner == "klms" else (5, 300)
    fm = rff_map(torch.Generator().manual_seed(0), d, dfeat, float(np.sqrt(d)),
                 device=cuda_device)
    hp = dict(mu=0.5) if learner == "klms" else dict(lam=1e-4, beta=0.9995)
    kw = dict(feature_map=fm, bank=64, chunk=8, log_capacity=64,
              rebuild_mode="blocked", device=cuda_device, **hp)
    plain = make_server(learner, **kw)
    obs = make_server(learner, trace=True, probe=True, recovery=True,
                      wal=str(tmp_path / "wal.jsonl"), **kw)
    wrapper = (rff_klms_bank_chunk_cuda if learner == "klms"
               else rff_krls_bank_chunk_cuda)
    before = wrapper.launches
    telemetry.reset()
    for t, x, y in _obs_traffic(700, d, 64, 1):
        plain.submit(t, x, y)
        obs.submit(t, x, y)
    plain.drain()
    obs.drain()
    assert all(torch.equal(a, b) for a, b in
               zip(plain.queue.state, obs.queue.state))
    xq = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, 8, d)).astype(np.float32)).to(cuda_device)
    assert torch.equal(plain.predict_block(xq), obs.predict_block(xq))
    op = "klms_chunk" if learner == "klms" else "krls_chunk"
    assert telemetry.registry().count("kernel.launches", op=op) == (
        wrapper.launches - before) > 0
    assert obs.probe.healthy() and not obs.recovery.history
    assert obs.check_read_contract(xq) <= 2e-2
    obs.wal.close()


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_every_lockstep_sync_is_a_spanned_wait_on_card(cuda_device, learner):
    """Over rounds of the lockstep tier's write, read and reset (slots on
    the card, and as a host list), every synchronizing call that
    ``torch.cuda``'s sync-debug mode sees sits in a ``host.wait``: its
    warnings count the rise of ``host.device_waits``."""
    import warnings

    from repro_torch.core.bank import (bank_predict_block, klms_bank_init,
                                       krls_bank_init)
    from repro_torch.obs import telemetry
    from repro_torch.serve import make_chunk_step, reset_slots

    d, dfeat = (16, 256) if learner == "klms" else (5, 300)
    fm = rff_map(torch.Generator().manual_seed(0), d, dfeat, float(np.sqrt(d)),
                 device=cuda_device)
    hp = dict(mu=0.5) if learner == "klms" else dict(lam=1e-4, beta=0.9995)
    step = make_chunk_step(learner, fm, **hp)
    state = (klms_bank_init(fm, 64) if learner == "klms"
             else krls_bank_init(fm, 64, 1e-4))
    a = _inputs(cuda_device, 64, 16, d, dfeat, seed=5)
    xq = a["xs"][:, :8].contiguous()
    on_card = torch.arange(0, 64, 8, device=cuda_device)

    def waits():
        return sum(v for k, v in telemetry.snapshot()["counters"].items()
                   if k.startswith("host.device_waits"))

    state, _ = step(state, a["xs"], a["ys"], a["mask"])  # builds the kernels
    torch.cuda.synchronize()
    before = waits()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for r in range(4):
                state, out = step(state, a["xs"], a["ys"], a["mask"])
                bank_predict_block(state, xq, fm)
                state = reset_slots(state, on_card if r % 2 else [r, r + 9],
                                    learner=learner, lam=1e-4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    print(learner, len(syncs), waits() - before, sorted(set(syncs)))
    assert len(syncs) == waits() - before >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("learner,kind,action", [
    ("klms", "nan_state", "rebuild"), ("klms", "log_corrupt", "reset"),
    ("krls", "asym_pmat", "resymmetrize"), ("klms", "drop_flush", "rebuild")])
def test_fault_repair_on_card(cuda_device, learner, kind, action):
    """A fault on the card: detected, quarantined (reads from the healthy
    row through predict_row), repaired on the expected rung and released;
    a rebuilt row equals the operator's readmit of the same log bit for
    bit, a reset row the fresh row, every other row the control's."""
    from repro_torch.core.bank import tenant_row
    from repro_torch.obs.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serve.snapshot import predict_row

    d, dfeat = (16, 256) if learner == "klms" else (5, 300)
    fm = rff_map(torch.Generator().manual_seed(0), d, dfeat, float(np.sqrt(d)),
                 device=cuda_device)
    hp = dict(mu=0.5) if learner == "klms" else dict(lam=1e-4, beta=0.9995)
    kw = dict(feature_map=fm, bank=16, chunk=8, policy="lru",
              log_capacity=256, rebuild_mode="blocked", device=cuda_device,
              **hp)
    srv, ctl = make_server(learner, recovery=True, **kw), make_server(
        learner, **kw)
    warm = _obs_traffic(400, d, 16, 3)
    for s in (srv, ctl):
        for t, x, y in warm:
            s.submit(t, x, y)
        s.drain()
    rec = srv.recovery
    xq = torch.ones(4, d, device=cuda_device)
    reads = []
    attempt = rec._attempt

    def checked(ep):
        if not ep.actions:
            reads.append(torch.equal(srv.predict(1, xq), predict_row(
                rec.healthy_row(1).theta, xq, srv.feature_map)))
        return attempt(ep)

    rec._attempt = checked
    inj = FaultInjector(srv, FaultPlan([Fault(kind, 1, 0)])).attach()
    # Other tenants' arrivals drive the faulted flush; a dropped flush
    # needs the target's backlog beside them.
    mid = [((1 if kind == "drop_flush" else 0) if i % 2 else 2, x, y)
           for i, (_, x, y) in enumerate(_obs_traffic(8, d, 16, 4))]
    for s in (srv, ctl):
        for t, x, y in mid:
            s.submit(t, x, y)
        s.flush()
        s.drain()
    inj.detach()
    assert reads == [True]
    assert [h.get("verified") for h in rec.history][-1] is True
    assert rec.history[-1]["action"] == action and not rec.quarantined
    slot = srv.resident[1]
    keep = [s for s in range(16) if s != slot]
    assert all(torch.equal(a[keep], b[keep])
               for a, b in zip(srv.queue.state, ctl.queue.state))
    row = tenant_row(srv.queue.state, slot)
    if action == "rebuild":
        xs, ys = ctl.log.arrays(1)
        op = tenant_row(ctl.snapshot_server._rebuild_fn(
            ctl.queue.state, slot, xs, ys), slot)
        assert all(torch.equal(a, b) for a, b in zip(row, op))
    elif action == "reset":
        assert all(torch.equal(a, b) for a, b in zip(row, srv._fresh_row))
    else:
        assert torch.equal(row.pmat, row.pmat.T)
        assert torch.equal(srv.predict(1, xq), ctl.predict(1, xq))


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["klms", "krls"])
def test_kill_restore_bitwise_on_card(cuda_device, learner, tmp_path):
    """Kill at a flush, restore on the card and replay the WAL: equal to
    the never-killed server bit for bit (leaves, snapshot, policy, ledger,
    reads)."""
    from repro_torch.serve import restore_checkpoint

    d, dfeat = (16, 256) if learner == "klms" else (5, 300)
    fm = rff_map(torch.Generator().manual_seed(0), d, dfeat, float(np.sqrt(d)),
                 device=cuda_device)
    hp = dict(mu=0.5) if learner == "klms" else dict(lam=1e-4, beta=0.9995)
    kw = dict(feature_map=fm, bank=16, chunk=8, policy="lru",
              log_capacity=256, size_watermark=8, rebuild_mode="blocked",
              device=cuda_device, **hp)
    wal = str(tmp_path / "wal.jsonl")
    traffic = _obs_traffic(600, d, 48, 5)
    orig = make_server(learner, wal=wal, **kw)
    for t, x, y in traffic[:233]:
        orig.submit(t, x, y)
    orig.checkpoint(tmp_path / "ckpt")
    for t, x, y in traffic[233:]:
        orig.submit(t, x, y)
    orig.drain()
    restored = make_server(learner, wal=wal, **kw)
    assert restore_checkpoint(restored, tmp_path / "ckpt")["replayed"] == 367
    restored.drain()
    for a, b in ((orig.queue.state, restored.queue.state),
                 (orig.snapshot.state, restored.snapshot.state)):
        assert all(x.device.type == cuda_device.type and torch.equal(x, y)
                   for x, y in zip(a, b))
    assert orig.policy.state_dict() == restored.policy.state_dict()
    assert orig._expected == restored._expected
    xq = torch.ones(4, d, device=cuda_device)
    for t in sorted(orig.resident)[:4]:
        assert torch.equal(orig.predict(t, xq), restored.predict(t, xq))
    orig.wal.close()
    restored.wal.close()


# ---------------------------------------------------------------------------
# The distribution tier: four gloo ranks on the card.
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _dist_run(tmp_path, world, job, **inputs) -> dict:
    """``tests/torch_dist_ranks.py`` at ``world`` ranks on the card."""
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_ranks.py"),
         str(world), "cuda", job, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp_path / "out.npz"))


def _dist_stream(d, dfeat, sigma, n, seed=0, nodes=None):
    """A map (numpy leaves) and model (9)'s stream, drawn on the CPU."""
    from repro_torch.core.rff import sample_rff
    from repro_torch.data.synthetic import gen_nonlinear_wiener

    g = torch.Generator().manual_seed(seed)
    rff = sample_rff(g, d, dfeat, sigma, device="cpu")
    xs, ys = gen_nonlinear_wiener(g, num_samples=n * (nodes or 1),
                                  input_dim=d)
    shape = (nodes, n) if nodes else (n,)
    return (rff.omega.numpy(), rff.bias.numpy(),
            xs.numpy().reshape(*shape, d), ys.numpy().reshape(shape))


def _dense_preds(omega, bias, xs, ys, lam, device, dtype=torch.float32):
    from repro_torch.core.krls import rff_krls_run

    tf = convert.trig_features(omega, bias, device=device)
    tf = type(tf)(*(a.to(dtype) for a in tf))
    _, out = rff_krls_run(tf, torch.from_numpy(xs).to(device, dtype),
                          torch.from_numpy(ys).to(device, dtype), lam=lam,
                          beta=0.9995)
    return out.prediction.double().cpu().numpy()


@pytest.mark.cuda
def test_sharded_krls_on_card_matches_dense(cuda_device, tmp_path):
    """tests/test_krls_sharded.py's shape (d = 5, D = 256, sigma = 5, lam =
    1e-2, 600 ticks) on four ranks: per tick within 1e-5 of the dense plain
    run, blocks of 8 and 32 within 5e-5, one all_reduce a tick and one a
    block, P gathered bitwise symmetric."""
    omega, bias, xs, ys = _dist_stream(5, 256, 5.0, 600)
    out = _dist_run(tmp_path, 4, "krls", omega=omega, bias=bias, xs=xs,
                    ys=ys, beta=0.9995, lams=np.array([1e-2]),
                    ks=np.array([1, 8, 32]), gather_p=1)
    want = _dense_preds(omega, bias, xs, ys, 1e-2, cuda_device)
    assert np.max(np.abs(out["pred_lam0_k1"] - want)) < 1e-5
    for k in (8, 32):
        pred = out[f"pred_lam0_k{k}"]
        assert np.max(np.abs(pred - want)) < 5e-5
        assert np.max(np.abs(pred - out["pred_lam0_k1"])) < 5e-5
        assert int(out[f"count_lam0_k{k}"]) == -(-600 // k)
    assert int(out["count_lam0_k1"]) == 600
    for k in (1, 8, 32):
        pmat = out[f"pmat_lam0_k{k}"]
        assert np.array_equal(pmat, pmat.T)


@pytest.mark.cuda
def test_sharded_krls_full_width_on_card(cuda_device, tmp_path):
    """The README memory model's width, D = 32768 (4 GiB of dense P), over
    four ranks for 256 ticks: lam = 1e-2 within 1e-4 of the dense f32 run,
    lam = 1e-4 within twice the dense f32 run's own distance from a float64
    run (plus 1e-5)."""
    omega, bias, xs, ys = _dist_stream(5, 32768, 5.0, 256, seed=1)
    out = _dist_run(tmp_path, 4, "krls", omega=omega, bias=bias, xs=xs,
                    ys=ys, beta=0.9995, lams=np.array([1e-2, 1e-4]),
                    ks=np.array([1]))
    torch.cuda.empty_cache()
    want = _dense_preds(omega, bias, xs, ys, 1e-2, cuda_device)
    assert np.max(np.abs(out["pred_lam0_k1"] - want)) < 1e-4
    want = _dense_preds(omega, bias, xs, ys, 1e-4, cuda_device)
    torch.cuda.empty_cache()
    exact = _dense_preds(omega, bias, xs, ys, 1e-4, cuda_device,
                         torch.float64)
    eps = np.max(np.abs(want - exact))
    assert np.max(np.abs(out["pred_lam1_k1"] - exact)) <= 2 * eps + 1e-5
    assert int(out["count_lam1_k1"]) == 256


@pytest.mark.cuda
def test_diffusion_on_card_matches_plain(cuda_device, tmp_path):
    """tests/test_distributed.py's configuration (four nodes, D = 100, mu
    = 0.5, 600 ticks a node), combining every tick and never: each node's
    ticks between combines through kernel 1, within 1e-4 of the nodes run
    as one plain bank with a mean over rows; combining every tick keeps
    the nodes equal bit for bit."""
    from repro_torch.kernels import ref

    omega, bias, xs, ys = _dist_stream(5, 100, 5.0, 600, seed=2, nodes=4)
    runs = [(1, 0), (10**9, 0)]
    out = _dist_run(tmp_path, 4, "diffusion", d_omega=omega, d_bias=bias,
                    d_xs=xs, d_ys=ys, mu=0.5, runs=np.array(runs))
    tf = convert.trig_features(omega, bias, device=cuda_device)
    xt = torch.from_numpy(xs).to(cuda_device)
    yt = torch.from_numpy(ys).to(cuda_device)
    for i, (every, _) in enumerate(runs):
        theta = torch.zeros(4, 100, device=cuda_device)
        errs = []
        for start in range(0, 600, every):
            stop = min(start + every, 600)
            theta, _, e = ref.rff_klms_bank_chunk_ref(
                theta, xt[:, start:stop], yt[:, start:stop], tf.omega,
                tf.bias, 0.5, None, tf.scale)
            errs.append(e)
            if stop % every == 0:
                theta = (theta.sum(0, keepdim=True) / 4).expand(4, -1)
                theta = theta.contiguous()
        want = torch.cat(errs, 1).cpu().numpy()
        assert np.max(np.abs(out[f"errs_run{i}"] - want)) < 1e-4
        assert np.max(np.abs(out[f"theta_run{i}"] - theta.cpu().numpy())) < 1e-4
    assert np.array_equal(out["theta_run0"], np.broadcast_to(
        out["theta_run0"][0], out["theta_run0"].shape))


# ---------------------------------------------------------------------------
# The remaining LM families (MLA, MoE, mamba2, the RG-LRU hybrid, frontends)
# ---------------------------------------------------------------------------


def _lax_top_k_route(gates, k, capacity):
    """jax.lax.top_k's order (the lower index first among equal gates) and
    repro's slot fill (token order, one k-slice at a time, the fill carried
    across slices), in numpy: (expert, slot, keep)."""
    g = gates.float().cpu().numpy()
    b, s, e = g.shape
    idx = np.argsort(-g, axis=-1, kind="stable")[..., :k]
    slot = np.zeros((b, s, k), np.int64)
    for bi in range(b):
        fill = np.zeros(e, np.int64)
        for j in range(k):
            for si in range(s):
                slot[bi, si, j] = fill[idx[bi, si, j]]
                fill[idx[bi, si, j]] += 1
    return idx, slot, slot < capacity


@pytest.mark.cuda
def test_moe_routing_bf16_ties_are_lax_top_k(cuda_device):
    """deepseek's routing (64 experts, top 6) on bf16 gates on the card,
    with forced ties and with the ties bf16 rounding makes, is bit for bit
    repro's rule."""
    from repro_torch.models import moe

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    levels = torch.randint(0, 4, (2, 96, 64), generator=gen,
                           device=cuda_device).float() / 8
    soft = torch.softmax(torch.randn(2, 512, 64, generator=gen,
                                     device=cuda_device) * 0.3, dim=-1)
    for gates in (levels.to(torch.bfloat16), soft.to(torch.bfloat16)):
        capacity = max(1, int(6 * gates.shape[1] * 1.25 / 64))
        expert, slot, keep, gate = moe.route(gates, 6, capacity)
        want = _lax_top_k_route(gates, 6, capacity)
        assert np.array_equal(expert.cpu().numpy(), want[0])
        assert np.array_equal(slot.cpu().numpy(), want[1])
        assert np.array_equal(keep.cpu().numpy(), want[2])
        assert gate.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_layer_runs_flash_at_published_heads(cuda_device, arch):
    """One MLA layer at published width in bf16 (deepseek: q/k heads of
    192, v 128; minicpm3: 96 and 64, 40 heads padded to 48): the prefill
    launches kernel 11 once, within 2e-2 of max|plain| of the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import attention

    cfg = get_config(arch)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    p = attention.mla_init(gen, cfg, cfg.activation_dtype, device=cuda_device)
    x = torch.randn(2, 512, cfg.d_model, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    before = flash_attention_cuda.launches
    got = attention.mla_apply(p, cfg, x)
    assert flash_attention_cuda.launches == before + 1
    want = attention.mla_apply(p, cfg, x, kernel_mode="ref")
    _hold_rel(got, want, 2e-2, f"{arch} MLA layer")


_FAMILY_DEPTH = {"minicpm3-4b": 2, "command-r-35b": 2, "arctic-480b": 1,
                 "mamba2-130m": 2, "recurrentgemma-2b": 4,
                 "internvl2-2b": 2, "musicgen-large": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(_FAMILY_DEPTH))
def test_lm_archs_at_published_width(cuda_device, arch):
    """chip_smoke.py phase 21 (b) at a cut depth: each arch at published
    width in bf16 (the hybrid as one group and one extra recurrent block):
    a prefill through kernel 11 once a layer where the arch has attention
    (the first layer's attention within 2e-2 of max|plain| of its plain
    version on the same input), none for mamba2 and the hybrid (the two
    modes the same bits), frontend archs through stub embeddings; a short
    generate; and, for the non-MoE families, an f32 copy's decode against
    its forward (tests/test_models.py's 2e-3)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import attention, transformer
    from repro_torch.models.frontend import stub_embeddings
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serve.serve_loop import generate
    from repro_torch.train.steps import make_prefill_step

    cfg = replace(get_config(arch), num_layers=_FAMILY_DEPTH[arch])
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    params = transformer.init_params(gen, cfg, device=cuda_device)
    if cfg.frontend is not None:
        x = stub_embeddings(gen, cfg, 1, 256, device=cuda_device)
        batch = {"embeds": x}
    else:
        toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                             device=cuda_device)
        batch = {"tokens": toks}
    before = flash_attention_cuda.launches
    got = make_prefill_step(cfg)(params, batch)
    launched = flash_attention_cuda.launches - before
    want = make_prefill_step(cfg, kernel_mode="ref")(params, batch)
    assert bool(torch.isfinite(got[:, :cfg.vocab_size]).all())
    if cfg.mixer == "attention":
        assert launched == cfg.num_layers
        h = rmsnorm(params["blocks"][0]["ln1"],
                    transformer.embed_inputs(params, cfg, batch.get("tokens"),
                                             batch.get("embeds")),
                    cfg.norm_eps)
        fn = {"mla": attention.mla_apply}.get(cfg.attention,
                                             attention.gqa_apply)
        _hold_rel(fn(params["blocks"][0]["attn"], cfg, h),
                  fn(params["blocks"][0]["attn"], cfg, h, kernel_mode="ref"),
                  2e-2, f"{arch} layer 0 attention")
    else:
        assert launched == 0 and torch.equal(got, want)
    prompt = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen,
                           device=cuda_device)
    before = flash_attention_cuda.launches
    out = generate(params, cfg, prompt, steps=4, max_len=8)
    assert flash_attention_cuda.launches == before  # decode: no kernel
    assert out.shape == (1, 4) and bool((out < cfg.vocab_size).all())
    if cfg.moe is not None:
        return
    cfg32 = replace(cfg, dtype="float32")
    p32 = _as_f32(params)
    del params
    small = {k: v[:, :8] for k, v in batch.items()}
    full = transformer.forward(p32, cfg32, small.get("tokens"),
                               small.get("embeds"))[..., :cfg.vocab_size]
    state = transformer.decode_state_init(cfg32, 1, 16, device=cuda_device)
    outs = []
    for i in range(8):
        if "tokens" in small:
            lg, state = transformer.decode_step(p32, cfg32, state,
                                                small["tokens"][:, i])
        else:
            lg, state = transformer.decode_step(
                p32, cfg32, state, embed_in=small["embeds"][:, i:i + 1])
        outs.append(lg[:, :cfg.vocab_size])
    dec = torch.stack(outs, 1)
    assert bool(((dec - full).abs() <= 2e-3 + 2e-3 * full.abs()).all())


def _as_f32(tree):
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    return tree.float()


# ---------------------------------------------------------------------------
# Training: kernels 10 and 11 under autograd, and the resume
# ---------------------------------------------------------------------------


def _attention_case(op, dtype, device, seed=0):
    """(inputs requiring grad, the incoming gradient) at qwen2-0.5b's
    training shape, one microbatch of 4 x 2048 (kernel 11: 56 heads of 64;
    kernel 10: D = 256 positive features)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if op == "flash":
        shapes = [(56, 2048, 64)] * 3
    else:
        shapes = [(56, 2048, 256), (56, 2048, 256), (56, 2048, 64)]
    xs = [torch.randn(s, generator=gen, device=device) for s in shapes]
    if op == "rff":
        xs[0], xs[1] = xs[0].abs() * 0.1, xs[1].abs() * 0.1
    xs = [x.to(dtype).requires_grad_() for x in xs]
    g = torch.randn(shapes[2], generator=gen, device=device).to(dtype)
    return xs, g


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [("flash", torch.float32),
                                      ("flash", torch.bfloat16),
                                      ("rff", torch.float32)])
def test_attention_kernel_grad_is_plain_grad(cuda_device, op, dtype):
    """Under autograd the kernel's forward (within 1e-4 of max|plain| at
    f32, 2e-2 at bf16), launched once and never in the backward; the
    backward recomputes the plain version, so the gradients equal plain
    autograd's on the same inputs bit for bit. Kernel 10 takes f32 (the
    model casts its features to f32)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rff_attention import rff_attention_cuda

    xs, g = _attention_case(op, dtype, cuda_device)
    wrapper = flash_attention_cuda if op == "flash" else rff_attention_cuda

    def call(mode, *args):
        if op == "flash":
            return ops.flash_attention(*args, mode=mode)
        return ops.rff_attention(*args, mode=mode)

    before = wrapper.launches
    out = call("cuda", *xs)
    assert out.grad_fn is not None and wrapper.launches == before + 1
    got = torch.autograd.grad(out, xs, g)
    assert wrapper.launches == before + 1
    plain_in = [x.detach().clone().requires_grad_() for x in xs]
    want_out = call("ref", *plain_in)
    _hold_rel(out, want_out, 1e-4 if dtype == torch.float32 else 2e-2,
              f"{op} forward")
    want = torch.autograd.grad(want_out, plain_in, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _train_cfg(attention, layers, dtype):
    from dataclasses import replace

    from repro_torch.configs import get_config

    return replace(get_config("qwen2-0.5b"), num_layers=layers,
                   attention=attention, dtype=dtype)


def _model_grads(cfg, params, tokens, mode):
    from repro_torch.models import lm_loss
    from repro_torch.optim.tree import leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, tokens=tokens, kernel_mode=mode)
    flat = leaves(live)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if x is None else x
                           for p, x in zip(flat, got)]


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["gqa", "rff"])
def test_model_grads_through_kernels_within_budget(cuda_device, attention):
    """qwen2-0.5b at published width, 2 layers, B = 2, S = 1024: at f32 the
    kernel path's loss gradients (kernel 11 on the CUDA cores, or kernel
    10) within 1e-4 of each leaf's norm of the plain path's; at bf16 each
    leaf's kernel-path gradient no farther from the f32 plain one than
    twice the bf16 plain path's distance plus 1e-3 of its norm (the budget
    rule of the logits)."""
    from repro_torch.models import init_params

    cfg32 = _train_cfg(attention, 2, "float32")
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    p32 = init_params(gen, cfg32, device=cuda_device)
    tokens = torch.randint(0, cfg32.vocab_size, (2, 1024), generator=gen,
                           device=cuda_device)
    _, exact = _model_grads(cfg32, p32, tokens, "ref")
    _, kern32 = _model_grads(cfg32, p32, tokens, "cuda")
    for i, (a, b) in enumerate(zip(kern32, exact)):
        err, norm = float((a - b).norm()), float(b.norm())
        assert err <= 1e-4 * norm, f"f32 leaf {i}: {err:.3g} of {norm:.3g}"
    cfg16 = _train_cfg(attention, 2, "bfloat16")
    p16 = _as_bf16(p32)
    _, kern = _model_grads(cfg16, p16, tokens, "cuda")
    _, plain = _model_grads(cfg16, p16, tokens, "ref")
    for i, (k, p, e) in enumerate(zip(kern, plain, exact)):
        d_k, d_p = float((k.float() - e).norm()), float((p.float() - e).norm())
        assert d_k <= 2 * d_p + 1e-3 * float(e.norm()), (
            f"bf16 leaf {i}: kernel {d_k:.3g}, plain {d_p:.3g}")


def _as_bf16(tree):
    """An f32 model's weights in bf16, the RFF feature buffers kept f32 as
    the model's init keeps them."""
    if isinstance(tree, dict):
        return {k: v if k in ("omega", "bias", "scale") and "wq" in tree
                else _as_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_bf16(v) for v in tree]
    return tree.to(torch.bfloat16)


@pytest.mark.cuda
def test_trainer_resume_bit_exact_on_card(cuda_device, tmp_path,
                                          monkeypatch):
    """qwen2-0.5b at published width, 2 layers, bf16: 4 steps straight
    equal 2 steps, a new Trainer, a resume and 2 more, bit for bit, under
    torch.use_deterministic_algorithms (the embedding's and the loss
    gather's backward accumulate with atomics otherwise); kernel 11 runs
    once a layer a microbatch."""
    from repro_torch.data.lm_data import batch_at_step
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.optim.tree import leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = _train_cfg("gqa", 2, "bfloat16")

    def batch_fn(step):
        return {"tokens": batch_at_step(0, step, global_batch=4, seq_len=512,
                                        vocab=cfg.vocab_size,
                                        device=cuda_device)}

    def trainer(total, name):
        return Trainer(cfg, TrainerConfig(total_steps=total, ckpt_every=100,
                                          ckpt_dir=str(tmp_path / name),
                                          num_microbatches=2,
                                          log_every=100),
                       batch_fn, device=cuda_device)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        before = flash_attention_cuda.launches
        ta = trainer(4, "a")
        ta.run()
        assert flash_attention_cuda.launches - before == 2 * 2 * 4
        trainer(2, "b").run()
        tb = trainer(4, "b")
        tb.run()
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(leaves(ta.state), leaves(tb.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The launch layer: DTensors on a one-rank mesh (chip_smoke.py phase 23)
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_mesh(cuda_device):
    """A ("data", "model") = (1, 1) DeviceMesh on a one-rank NCCL group,
    destroyed after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype,seq", [("flash", torch.bfloat16, False),
                                          ("flash", torch.bfloat16, True),
                                          ("rff", torch.float32, False)])
def test_attention_kernels_through_the_dtensor_boundary(one_rank_mesh, op,
                                                        dtype, seq):
    """Kernels 11 and 10 on DTensor inputs (rows Shard(0), or the sequence
    Shard(1), which is made whole first) launch once on the local shards:
    the output, and under autograd the gradients, bit for bit the
    plain-tensor call's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rff_attention import rff_attention_cuda

    xs, g = _attention_case(op, dtype, one_rank_mesh.device_type)
    wrapper = flash_attention_cuda if op == "flash" else rff_attention_cuda
    call = ops.flash_attention if op == "flash" else ops.rff_attention
    places = (Shard(1) if seq else Shard(0), Replicate())

    def placed(x):
        return DTensor.from_local(x, one_rank_mesh, places, run_check=False)

    want = call(*xs, mode="cuda")
    want_g = torch.autograd.grad(want, xs, g)
    dx = [x.detach().clone().requires_grad_() for x in xs]
    before = wrapper.launches
    got = call(*[placed(x) for x in dx], mode="cuda")
    assert isinstance(got, DTensor) and wrapper.launches == before + 1
    got_g = torch.autograd.grad(got, dx, placed(g))
    assert torch.equal(got.full_tensor(), want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dtensor_train_step_bitwise_on_one_rank_mesh(one_rank_mesh,
                                                     monkeypatch):
    """qwen2-0.5b at published width, 2 layers, bf16: the train step on its
    state as DTensors (param_specs, moment_specs of train_4k, batch_axes
    from train_batch_axes, grad_specs the param placements) equals the
    plain step in every leaf and metric, under deterministic algorithms;
    kernel 11 runs once a layer a microbatch through the boundary."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import sharding, specs
    from repro_torch.optim.optimizers import AdamWState
    from repro_torch.optim.tree import leaves
    from repro_torch.train.steps import init_train_state, make_train_step

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg, _ = specs.resolve_cell(_train_cfg("gqa", 2, "bfloat16"),
                                SHAPES["train_4k"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    state = init_train_state(gen, cfg, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 512),
                                     generator=gen, device=dev)}
    baxes = specs.train_batch_axes(cfg, ShapeSpec("train", 512, 4, "train"),
                                   one_rank_mesh)
    pinned = replace(cfg, activation_batch_axes=baxes)
    pspec = sharding.param_specs(pinned, one_rank_mesh, state["params"])
    mspec = sharding.moment_specs(pinned, one_rank_mesh, state["params"])
    dstate = {"params": sharding.distribute(state["params"], one_rank_mesh,
                                            pspec),
              "opt": AdamWState(
                  m=sharding.distribute(state["opt"].m, one_rank_mesh, mspec),
                  v=sharding.distribute(state["opt"].v, one_rank_mesh, mspec),
                  count=state["opt"].count),
              "step": state["step"]}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        before = flash_attention_cuda.launches
        got, got_m = make_train_step(pinned, num_microbatches=2,
                                     batch_axes=baxes, grad_specs=pspec)(
            dstate, batch)
        assert flash_attention_cuda.launches - before == 2 * 2
        want, want_m = make_train_step(cfg, num_microbatches=2)(state, batch)
    finally:
        torch.use_deterministic_algorithms(was)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(whole(a), b)
    for k in want_m:
        assert torch.equal(whole(got_m[k]), want_m[k])


@pytest.mark.cuda
def test_dtensor_prefill_bitwise_on_one_rank_mesh(one_rank_mesh):
    """deepseek-v2-lite-16b at published width, 2 layers: the prefill with
    its weights as DTensors under prefill_32k's layout equals the plain
    prefill bit for bit, kernel 11 (the MLA shape) once a layer through the
    boundary."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import sharding, specs
    from repro_torch.models import init_params
    from repro_torch.train.steps import make_prefill_step

    cfg, _ = specs.resolve_cell(replace(get_config("deepseek-v2-lite-16b"),
                                        num_layers=2), SHAPES["prefill_32k"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    params = init_params(gen, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                           device=dev)
    with torch.no_grad():
        want = make_prefill_step(cfg)(params, {"tokens": tokens})
        dparams = sharding.distribute(
            params, one_rank_mesh,
            sharding.param_specs(cfg, one_rank_mesh, params))
        before = flash_attention_cuda.launches
        got = make_prefill_step(cfg)(dparams, {"tokens": tokens})
        assert flash_attention_cuda.launches - before == 2
    assert torch.equal(got.full_tensor(), want)
