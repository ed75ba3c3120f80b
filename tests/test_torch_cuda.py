"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without one.
The file imports neither JAX nor ``repro``, so it runs on a machine that
has only PyTorch; ``tests/conftest.py`` imports JAX, so run it there as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 at f32 (FMA contraction, another summation order in the
projection and the theta . z reduction, and ``cosf`` against PyTorch's
cos move results by a few ulp of ``|x W + b|``); 1e-3 for bf16 reads (an
f32 difference that moves z across a bf16 rounding boundary changes that
feature by one bf16 ulp, 2^-8 relative). The contracts between the two
KLMS kernels are bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.features import rff_map
from repro_torch.kernels import ops
from repro_torch.kernels.ref import default_scale
from repro_torch.kernels.rff_klms_step import rff_klms_bank_chunk_cuda
from repro_torch.serve import make_server

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
        big = torch.zeros(1, 40_000, device=cuda_device)
        rff_klms_bank_chunk_cuda(
            big, a["xs"][:1], a["ys"][:1],
            torch.zeros(3, 40_000, device=cuda_device),
            torch.zeros(40_000, device=cuda_device), 0.5)


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
