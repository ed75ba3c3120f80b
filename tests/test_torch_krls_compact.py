"""The KRLS compact route's plain version held against ``repro`` on the CPU.

``krls_chunk_compact_ref`` (``repro_torch/kernels/ref.py``) is the algebra
of ``csrc/krls_compact.cu``: the ticks in blocks of Tc, each block's pz_k
formed from P_0 z_k and the earlier ticks (float64 recursion), P updated
once a block by the block's rank-L correction. It equals the tick
recursion in exact arithmetic. Inputs come from
``np.random.default_rng(seed)`` and go through it and through ``repro``'s
``rff_krls_bank_chunk_ref`` (JAX, CPU).

Tolerances:
* a chunk at P = 10 I + A A^T (tests/test_chunked.py's kind) or at a fresh
  P = I / lam with lam = 1e-2: 1e-5 atol and rtol, the bound of
  tests/test_chunked.py::test_krls_chunk_kernel_sweep;
* a served stream at the paper's lam = 1e-4 (sigma = 5, beta = 0.9995): f32
  itself is the limit (tests/test_torch_krls.py explains why), so the
  compact form's f32 result must be within twice the tick form's own f32
  distance from a float64 tick run, plus the 1e-5 floor.
The contracts of the plain version that the kernel keeps bit for bit (a
fully masked tenant returns its P and theta, n calls of Tc ticks equal one
call of n Tc, P' is symmetric) are exact. The kernel itself is held against
this plain version on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro.features.base import uniform_trig_scale as jax_uniform_scale
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import chunking, ref
from repro_torch.kernels.rff_krls_step import (
    KRLS_ROUTES,
    rff_krls_bank_chunk_cuda,
    rff_krls_bank_step_cuda,
)

torch.set_num_threads(2)

TOL = 1e-5


def _inputs(seed, bank, d, dfeat, tlen, kind="spd", lam=None):
    """Chunk inputs: P = 10 I + A A^T (``"spd"``), that plus a non-symmetric
    part (``"asym"``), or I / lam; per-tenant beta in [0.9, 1); a mask."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if lam is not None:
        pmat = np.broadcast_to(np.eye(dfeat) / lam, (bank, dfeat, dfeat))
    else:
        a = 0.1 * rng.normal(size=(bank, dfeat, dfeat))
        pmat = 10.0 * np.eye(dfeat) + np.einsum("bij,bkj->bik", a, a)
        if kind == "asym":
            pmat = pmat + 0.5 * rng.normal(size=pmat.shape)
    return dict(
        theta=(0.3 * rng.normal(size=(bank, dfeat))).astype(f32),
        pmat=np.ascontiguousarray(pmat, f32),
        xs=rng.normal(size=(bank, tlen, d)).astype(f32),
        ys=rng.normal(size=(bank, tlen)).astype(f32),
        mask=(rng.random((bank, tlen)) > 0.4).astype(f32),
        w=rng.normal(size=(d, dfeat)).astype(f32),
        b=rng.uniform(0, 2 * np.pi, size=dfeat).astype(f32),
        s=np.asarray(jax_uniform_scale(dfeat)),
        beta=rng.uniform(0.9, 1.0, size=bank).astype(f32),
    )


def _t(a):
    return None if a is None else convert.tensor(a, device="cpu")


def _args(a, mask):
    return [a[k] for k in ("theta", "pmat", "xs", "ys", "w", "b", "beta")] + [
        mask, a["s"]]


@pytest.mark.parametrize("tc", [1, 4, 16])
@pytest.mark.parametrize("tlen,kind,masked", [
    (16, "spd", False), (16, "spd", True), (37, "spd", True),
    (37, "asym", True), (16, "asym", False), (7, "fresh", True),
])
def test_compact_ref_matches_repro(tc, tlen, kind, masked):
    """B = 3, d = 4, D = 40 at per-tenant beta: masks, an asymmetric P_0,
    a fresh P = I / 1e-2 (over 7 ticks, the reference sweep's longest: its
    O(1) entries are differences of O(100) ones, and past some 16 ticks the
    port's own tick version leaves 1e-5 of repro's too), T = 37 not a
    multiple of Tc, and tenant 1 fully masked (its P and theta come back
    bit for bit)."""
    a = _inputs(11, 3, 4, 40, tlen, kind="asym" if kind == "asym" else "spd",
                lam=1e-2 if kind == "fresh" else None)
    mask = a["mask"].copy() if masked else np.ones_like(a["ys"])
    mask[1] = 0.0
    want = jref.rff_krls_bank_chunk_ref(*_args(a, mask))
    got = ref.krls_chunk_compact_ref(*map(_t, _args(a, mask)), tc=tc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(convert.to_numpy(g), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    assert torch.equal(got[0][1], _t(a["theta"][1]))
    assert torch.equal(got[1][1], _t(a["pmat"][1]))
    assert torch.equal(got[1][0], got[1][0].T)


def test_compact_ref_blocks_compose_bit_for_bit():
    """Two calls of Tc ticks in order equal one call of 2 Tc, and the
    default Tc is chunking.KRLS_COMPACT_TC."""
    tc = chunking.KRLS_COMPACT_TC
    a = _inputs(12, 4, 5, 48, 2 * tc, kind="asym")
    args = list(map(_t, _args(a, a["mask"])))
    whole = ref.krls_chunk_compact_ref(*args)
    head = ref.krls_chunk_compact_ref(*args[:2], args[2][:, :tc],
                                      args[3][:, :tc], *args[4:7],
                                      args[7][:, :tc], args[8], tc=tc)
    tail = ref.krls_chunk_compact_ref(head[0], head[1], args[2][:, tc:],
                                      args[3][:, tc:], *args[4:7],
                                      args[7][:, tc:], args[8], tc=tc)
    assert torch.equal(whole[0], tail[0]) and torch.equal(whole[1], tail[1])
    assert torch.equal(whole[2], torch.cat([head[2], tail[2]], 1))
    assert torch.equal(whole[3], torch.cat([head[3], tail[3]], 1))


def _paper_stream(seed, bank, dfeat, flushes=6, tlen=16, d=5, sigma=5.0):
    """Ragged flushes of a (bank, 16) chunk at the paper's section 6 map:
    each tenant's first ``count`` ticks live, count uniform in [0, 16]."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d, dfeat)) / sigma).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, size=dfeat).astype(np.float32)
    dirs = rng.normal(size=(bank, d)) / np.sqrt(d)
    stream = []
    for _ in range(flushes):
        counts = rng.integers(0, tlen + 1, size=bank)
        mask = (np.arange(tlen)[None] < counts[:, None]).astype(np.float32)
        xs = rng.normal(size=(bank, tlen, d)).astype(np.float32)
        ys = 1.0 + 0.5 * np.sin(np.einsum("btd,bd->bt", xs, dirs))
        ys = (ys + 0.05 * rng.normal(size=(bank, tlen))).astype(np.float32)
        stream.append((xs, ys, mask))
    return w, b, stream


def _serve(fn, w, b, stream, dtype, lam=1e-4, beta=0.9995):
    bank, dfeat = stream[0][1].shape[0], w.shape[1]
    theta = torch.zeros(bank, dfeat, dtype=dtype)
    pmat = (torch.eye(dfeat, dtype=dtype) / lam).expand(
        bank, dfeat, dfeat).contiguous()
    s = ref.default_scale(dfeat, dtype)
    errs = []
    for xs, ys, mask in stream:
        theta, pmat, _, err = fn(
            theta, pmat, *(torch.from_numpy(v).to(dtype) for v in (xs, ys)),
            torch.from_numpy(w).to(dtype), torch.from_numpy(b).to(dtype),
            beta, torch.from_numpy(mask).to(dtype), s)
        errs.append(err[torch.from_numpy(mask) > 0])
    return theta.double(), pmat.double(), torch.cat(errs).double()[None]


def _normwise(got, want):
    g, w = got.flatten(1), want.flatten(1)
    return float(((g - w).abs().amax(1) / (1 + w.abs().amax(1))).max())


def _p_rel(got, want):
    g, w = got.flatten(1), want.flatten(1)
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_ref_paper_lambda_within_f32_budget(seed):
    """At lam = 1e-4 the compact form in f32 is within twice the tick
    form's own f32 distance from a float64 tick run (plus 1e-5), for theta,
    P and every live tick's prior error, over six ragged flushes."""
    w, b, stream = _paper_stream(seed, 12, 96)
    exact = _serve(ref.rff_krls_bank_chunk_ref, w, b, stream, torch.float64)
    plain = _serve(ref.rff_krls_bank_chunk_ref, w, b, stream, torch.float32)
    compact = _serve(ref.krls_chunk_compact_ref, w, b, stream, torch.float32)
    for name, k, dist in (("theta", 0, _normwise), ("P", 1, _p_rel),
                          ("prior errors", 2, _normwise)):
        budget = dist(plain[k], exact[k])
        got = dist(compact[k], exact[k])
        assert got <= 2 * budget + TOL, (name, got, budget)


def test_compact_workspace_and_slabs():
    """The workspace is 28 B Tc D a tenant plus the packed operands, each
    part on a 256-byte boundary; tenants go in slabs under 256 MiB: all of
    the serving bank at D = 400, 583 of it at D = 1024, one tenant at
    least; a call of T < Tc sizes its block by T."""
    tc = chunking.KRLS_COMPACT_TC
    assert tc == 16
    one = chunking.krls_compact_workspace_bytes(1, tc, 5, 1024)
    two = chunking.krls_compact_workspace_bytes(2, tc, 5, 1024)
    assert two - one >= 28 * tc * 1024
    assert one % 256 == 0 and two % 256 == 0
    budget = chunking.KRLS_COMPACT_WORKSPACE_BUDGET
    assert budget == 256 << 20
    assert chunking.krls_compact_slab(1024, 16, 5, 400) == 1024
    slab = chunking.krls_compact_slab(1024, 16, 5, 1024)
    assert slab == 583
    assert chunking.krls_compact_workspace_bytes(slab, tc, 5, 1024) <= budget
    assert chunking.krls_compact_workspace_bytes(slab + 1, tc, 5, 1024) > budget
    assert chunking.krls_compact_slab(2, 16, 5, 400_000) == 1
    assert chunking.krls_compact_slab(1024, 1, 5, 1024) == 1024


def test_routes_refuse_an_unknown_name():
    """``_route=`` takes "resident", "compact" or "streaming" and refuses
    any other name before it looks at the tensors."""
    assert KRLS_ROUTES == ("resident", "compact", "streaming")
    a = _inputs(13, 2, 3, 16, 2)
    args = list(map(_t, _args(a, None)))
    with pytest.raises(ValueError, match="unknown KRLS route"):
        rff_krls_bank_chunk_cuda(*args, _route="tiled")
    with pytest.raises(ValueError, match="unknown KRLS route"):
        rff_krls_bank_step_cuda(args[0], args[1], args[2][:, 0], args[3][:, 0],
                                *args[4:7], args[8], _route="blocked")
    for route in KRLS_ROUTES:  # a known name reaches the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            rff_krls_bank_chunk_cuda(*args, _route=route)
