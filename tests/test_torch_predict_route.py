"""The read kernel's two routes (csrc/bank_predict.cu) on the CPU.

``chunking.predict_route`` sends a read to the "few" route where the bank
route's blocks of 128 (tenant, query) rows would number fewer than
``PREDICT_FEW_BLOCKS`` and z's ``(R, Dp)`` f32 workspace fits its budget,
and to the "bank" route otherwise; the route changes no bit of a read, so
the rule is free (the card tests hold that). Here: the rule at the shapes
the card tests and ``chip_smoke.py`` hold, the serving shapes staying on
the bank route; the few-row workspace's bytes; the wrapper's route knob;
and ``mode="auto"`` on CPU tensors taking the plain version, one tenant's
read held against ``repro``'s Pallas kernel in interpret mode at 1e-5
(f32; 2e-2 under the bf16 contract, as tests/test_torch_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro.features.base import uniform_trig_scale as jax_uniform_scale
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.kernels import chunking, ops, ref
from repro_torch.kernels import rff_predict

torch.set_num_threads(2)

TOL, BF16_TOL = 1e-5, 2e-2

# (B, Q, d, D): one tenant at the KLMS serving widths, one query, two
# tenants, the KRLS read's width and a compact width, the sharded KRLS
# predict's partial (D / n = 8192), and ragged B Q in {1, 7, 129} at D in
# {300, 2049}.
FEW = [(1, 64, 128, 2048), (1, 1, 128, 2048), (2, 64, 128, 2048),
       (1, 64, 5, 300), (1, 13, 5, 400), (1, 64, 5, 8192),
       *((bq, 1, 5, dfeat) for bq in (1, 7, 129) for dfeat in (300, 2049))]
# The serving reads: the KLMS bank's block (1024, 64) and the KRLS one's.
BANK = [(1024, 64, 128, 2048), (1024, 64, 5, 300)]


@pytest.mark.parametrize("bank,qlen,d,dfeat", FEW)
def test_few_row_shapes_take_the_few_route(bank, qlen, d, dfeat):
    assert chunking.predict_route(bank * qlen, dfeat) == "few"


@pytest.mark.parametrize("bank,qlen,d,dfeat", BANK)
def test_serving_shapes_stay_on_the_bank_route(bank, qlen, d, dfeat):
    assert chunking.predict_route(bank * qlen, dfeat) == "bank"


def test_route_rule_edges():
    """Fewer than PREDICT_FEW_BLOCKS blocks of 128 rows go few; z past its
    budget, or more column tiles than the grid takes, stay on the bank
    route."""
    blocks = chunking.PREDICT_FEW_BLOCKS
    assert blocks == 132  # a wave of the H100's 132 SMs
    assert chunking.predict_route(128 * (blocks - 1), 2048) == "few"
    assert chunking.predict_route(128 * (blocks - 1) + 1, 2048) == "bank"
    budget = chunking.PREDICT_FEW_Z_BUDGET
    assert budget == 256 << 20
    dfeat = budget // (4 * 64)  # one tenant's 64 rows of z at the budget
    assert chunking.predict_route(64, dfeat) == "few"
    assert chunking.predict_route(64, dfeat + 1) == "bank"
    assert chunking.predict_route(1, 128 * 65_535) == "few"
    assert chunking.predict_route(1, 128 * 65_535 + 1) == "bank"
    assert chunking.PREDICT_ROUTES == ("bank", "few")


@pytest.mark.parametrize("bf16", [False, True])
def test_few_row_workspace_bytes(bf16):
    """The few route's workspace is the bank route's packed operands, then
    z (R, Dp) in f32: 512 KiB of z at one tenant's 64 queries, D = 2048."""
    rows, d, dfeat = 64, 128, 2048
    packed = chunking.predict_workspace_bytes(rows, d, dfeat, bf16)
    assert chunking.predict_workspace_bytes(rows, d, dfeat, bf16,
                                            "bank") == packed
    few = chunking.predict_workspace_bytes(rows, d, dfeat, bf16, "few")
    assert few - packed == 512 * 1024
    # f32: W with b and s (130, 2048) and x^T (128, 128) floats; bf16: b
    # and s (2, 2048) f32, W^T (2048, 128) and x (128, 128) bf16.
    want = (130 * 2048 + 128 * 128) * 4 if not bf16 else (
        8 * 2048 + 2 * 128 * (128 + 2048))
    assert packed == want
    # Ragged: z holds R rows of Dp = D rounded up to 128 columns.
    for rows, dfeat in ((7, 300), (129, 2049), (1, 17)):
        dp_cols = -(-dfeat // 128) * 128
        assert (chunking.predict_workspace_bytes(rows, 5, dfeat, bf16, "few")
                - chunking.predict_workspace_bytes(rows, 5, dfeat, bf16)
                == 4 * rows * dp_cols)


def test_wrapper_route_knob_and_counts():
    """An unknown route raises before the device check; the wrapper counts
    its calls per route; CPU tensors are refused on either route."""
    assert set(rff_predict.rff_bank_predict_cuda.route_launches) == set(
        chunking.PREDICT_ROUTES)
    t = torch.zeros(1, 8)
    xq, w, b = torch.zeros(1, 2, 3), torch.zeros(3, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="unknown read route"):
        rff_predict.rff_bank_predict_cuda(t, xq, w, b, _route="wide")
    for route in (None, *chunking.PREDICT_ROUTES):
        with pytest.raises(ValueError, match="CUDA tensors"):
            rff_predict.rff_bank_predict_cuda(t, xq, w, b, _route=route)


def _inputs(seed, bank, qlen, d, dfeat):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (0.3 * rng.normal(size=(bank, dfeat))).astype(f32),
        rng.normal(size=(bank, qlen, d)).astype(f32),
        (rng.normal(size=(d, dfeat)) / np.sqrt(d)).astype(f32),
        rng.uniform(0, 2 * np.pi, size=dfeat).astype(f32),
        np.asarray(jax_uniform_scale(dfeat)),
    )


def _t(a):
    return convert.tensor(a, device="cpu")


@pytest.mark.parametrize("precision,tol", [(None, TOL), ("bf16", BF16_TOL)])
@pytest.mark.parametrize("bank,qlen,d,dfeat", [(1, 64, 16, 256),
                                               (1, 13, 5, 300)])
def test_one_tenant_read_on_cpu_is_the_plain_version(monkeypatch, bank, qlen,
                                                     d, dfeat, precision,
                                                     tol):
    """mode="auto" on CPU tensors never reaches the CUDA wrapper: the read
    is the plain version bit for bit, and one tenant's read agrees with
    repro's Pallas kernel run in interpret mode."""
    args = _inputs(11, bank, qlen, d, dfeat)

    def no_kernel(*a, **k):
        raise AssertionError("the CUDA read kernel was called on the CPU")

    monkeypatch.setattr(ops, "rff_bank_predict_cuda", no_kernel)
    got = ops.rff_bank_predict(*map(_t, args), precision=precision)
    assert got.shape == (bank, qlen) and got.device.type == "cpu"
    assert torch.equal(got, ref.rff_bank_predict_ref(*map(_t, args),
                                                     precision=precision))
    want = jops.rff_bank_predict(*args, mode="interpret", precision=precision)
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=tol, rtol=tol)
