"""The port's KLMS-slice kernels held against ``repro`` on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through the
``repro`` function and its ``repro_torch`` counterpart (``device="cpu"``,
which runs each kernel's plain PyTorch version). ``repro`` runs as its own
tests run it on the CPU: the Pallas kernel in interpret mode at two tiny
shapes, the ``ref.py`` oracle (``mode="xla"``) elsewhere.

Tolerances:
* 1e-5 atol and rtol for one step, one chunk or one predict at f32, as in
  tests/test_kernels_pallas.py: both sides compute in f32, but XLA and
  PyTorch sum the projection and the theta . z reduction in different
  orders and their cos differ by an ulp.
* bf16 reads: 2e-2, the contract of tests/test_read_path.py (bf16 keeps an
  8-bit mantissa; a D-term f32 sum of bf16-rounded features lands within
  about 2^-8 of the f32 path).
The port's own contracts (chunk == steps, masked tick, chunking helpers)
are exact. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.features.base import uniform_trig_scale as jax_uniform_scale
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core.rff import gaussian_kernel, kernel_estimate, sample_rff
from repro_torch.features.base import uniform_trig_scale
from repro_torch.kernels import chunking, ops, ref

torch.set_num_threads(2)


SWEEP = [(64, 8, 256), (7, 5, 300), (1, 1, 17), (33, 8, 129)]
TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(seed, bank, d, dfeat, tlen=4, per_mu=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        theta=(0.3 * rng.normal(size=(bank, dfeat))).astype(f32),
        xs=rng.normal(size=(bank, tlen, d)).astype(f32),
        ys=rng.normal(size=(bank, tlen)).astype(f32),
        mask=(rng.random((bank, tlen)) > 0.3).astype(f32),
        w=rng.normal(size=(d, dfeat)).astype(f32),
        b=rng.uniform(0, 2 * np.pi, size=dfeat).astype(f32),
        s=np.asarray(jax_uniform_scale(dfeat)),
        mu=(rng.uniform(0.05, 1.5, size=bank).astype(f32) if per_mu
            else np.float32(0.5)),
    )


def _t(a):
    return convert.tensor(a, device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        convert.to_numpy(got), np.asarray(want), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("bank,d,dfeat", SWEEP)
@pytest.mark.parametrize("per_mu", [False, True])
def test_klms_step_matches_repro(bank, d, dfeat, per_mu):
    a = _inputs(0, bank, d, dfeat, per_mu=per_mu)
    want = jref.rff_klms_bank_step_ref(
        a["theta"], a["xs"][:, 0], a["ys"][:, 0], a["w"], a["b"], a["mu"],
        a["s"],
    )
    got = ops.rff_klms_bank_step(
        _t(a["theta"]), _t(a["xs"][:, 0]), _t(a["ys"][:, 0]), _t(a["w"]),
        _t(a["b"]), _t(a["mu"]), _t(a["s"]),
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bank,d,dfeat", SWEEP)
@pytest.mark.parametrize("per_mu", [False, True])
def test_klms_chunk_matches_repro(bank, d, dfeat, per_mu):
    a = _inputs(1, bank, d, dfeat, tlen=5, per_mu=per_mu)
    want = jref.rff_klms_bank_chunk_ref(
        a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"], a["mask"],
        a["s"],
    )
    got = ops.rff_klms_bank_chunk(
        _t(a["theta"]), _t(a["xs"]), _t(a["ys"]), _t(a["w"]), _t(a["b"]),
        _t(a["mu"]), _t(a["mask"]), _t(a["s"]),
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bank,d,dfeat", [(7, 5, 300), (1, 1, 17)])
def test_klms_kernels_match_repro_pallas_interpret(bank, d, dfeat):
    """Against the Pallas kernels themselves, in interpret mode."""
    a = _inputs(2, bank, d, dfeat, tlen=3, per_mu=True)
    want = jops.rff_klms_bank_chunk(
        a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"], a["mask"],
        a["s"], mode="interpret",
    )
    got = ops.rff_klms_bank_chunk(
        _t(a["theta"]), _t(a["xs"]), _t(a["ys"]), _t(a["w"]), _t(a["b"]),
        _t(a["mu"]), _t(a["mask"]), _t(a["s"]),
    )
    for g, w in zip(got, want):
        _close(g, w)
    want = jops.rff_klms_bank_step(
        a["theta"], a["xs"][:, 0], a["ys"][:, 0], a["w"], a["b"], a["mu"],
        a["s"], mode="interpret",
    )
    got = ops.rff_klms_bank_step(
        _t(a["theta"]), _t(a["xs"][:, 0]), _t(a["ys"][:, 0]), _t(a["w"]),
        _t(a["b"]), _t(a["mu"]), _t(a["s"]),
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bank,d,dfeat", SWEEP)
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_predict_matches_repro(bank, d, dfeat, precision):
    a = _inputs(3, bank, d, dfeat, tlen=13)
    args = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
    want = jref.rff_bank_predict_ref(*args, precision)
    got = ops.rff_bank_predict(*map(_t, args), precision=precision)
    _close(got, want, TOL if precision is None else BF16_TOL)
    if precision == "bf16":
        f32 = ops.rff_bank_predict(*map(_t, args))
        err = float((got - f32).abs().max())
        assert 0 < err < BF16_TOL  # bf16 really ran, within the contract
        want32 = jref.rff_bank_predict_ref(*args)
        assert float(jnp.max(jnp.abs(want - want32))) < BF16_TOL


def test_predict_matches_repro_pallas_interpret():
    a = _inputs(4, 5, 4, 64, tlen=13)
    args = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
    for precision, tol in ((None, TOL), ("bf16", BF16_TOL)):
        want = jops.rff_bank_predict(*args, mode="interpret",
                                     precision=precision)
        got = ops.rff_bank_predict(*map(_t, args), precision=precision)
        _close(got, want, tol)


@pytest.mark.parametrize("tlen", [1, 16])
def test_chunk_equals_steps_bitwise(tlen):
    """A chunk of T ticks is T step calls bit for bit (T=1: one step)."""
    a = _inputs(5, 9, 6, 130, tlen=tlen, per_mu=True)
    w, b, s, mu = _t(a["w"]), _t(a["b"]), _t(a["s"]), _t(a["mu"])
    theta_c, pred_c, err_c = ops.rff_klms_bank_chunk(
        _t(a["theta"]), _t(a["xs"]), _t(a["ys"]), w, b, mu, None, s
    )
    theta = _t(a["theta"])
    for t in range(tlen):
        theta, pred, err = ops.rff_klms_bank_step(
            theta, _t(a["xs"][:, t]), _t(a["ys"][:, t]), w, b, mu, s
        )
        assert torch.equal(pred, pred_c[:, t])
        assert torch.equal(err, err_c[:, t])
    assert torch.equal(theta, theta_c)


def test_masked_tick_is_noop():
    """mask == 0 leaves theta bit for bit and still emits the prior
    prediction and error."""
    a = _inputs(6, 7, 5, 300, tlen=3)
    args = [_t(a[k]) for k in ("theta", "xs", "ys", "w", "b")]
    theta, pred, err = ops.rff_klms_bank_chunk(
        *args, 0.5, torch.zeros(7, 3), _t(a["s"])
    )
    assert torch.equal(theta, args[0])
    want = ref.rff_bank_predict_ref(args[0], args[1], args[3], args[4],
                                    _t(a["s"]))
    torch.testing.assert_close(pred, want, atol=TOL, rtol=TOL)
    assert torch.equal(err, args[2] - pred)


def test_chunk_splitting_matches_one_launch():
    """``chunk=k`` (ceil(T/k) launches, zero-masked remainder) equals one
    launch over all T."""
    a = _inputs(7, 6, 3, 40, tlen=11)
    args = [_t(a[k]) for k in ("theta", "xs", "ys", "w", "b")]
    one = ops.rff_klms_bank_chunk(*args, 0.4, _t(a["mask"]), _t(a["s"]))
    split = ops.rff_klms_bank_chunk(*args, 0.4, _t(a["mask"]), _t(a["s"]),
                                    chunk=4)
    for g, w in zip(split, one):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,chunk", [(10, 4), (8, 8), (1, 3), (13, 1)])
def test_time_blocks_roundtrip(n, chunk):
    a = torch.arange(3 * n * 2, dtype=torch.float32).reshape(3, n, 2)
    blocks = chunking.time_blocks(a, chunk, axis=1)
    nc = chunking.num_chunks(n, chunk)
    assert blocks.shape == (nc, 3, chunk, 2)
    assert torch.equal(chunking.unblock_time(blocks, n, axis=1), a)
    mask = chunking.valid_time_mask(n, chunk)
    assert mask.shape == (nc, chunk) and float(mask.sum()) == n
    assert torch.equal(mask.reshape(-1)[n:], torch.zeros(nc * chunk - n))


def test_klms_block_sizing():
    """The KLMS kernels' plan: theta in a warp's registers up to D = 2048
    (4, 16 or 64 columns a lane), in shared memory beyond, refused past
    D = 58,112 (one tenant's theta in a block's shared memory, above the
    first design's 29k); the feature tile's grid."""
    assert chunking.klms_tick_plan(17) == (4, 0)
    assert chunking.klms_tick_plan(300) == (16, 0)
    assert chunking.klms_tick_plan(2048) == (64, 0)
    assert chunking.klms_tick_plan(2049) == (0, 4 * 2049)
    assert chunking.klms_tick_plan(58_112) == (0, chunking.SMEM_BUDGET)
    assert chunking.klms_fits(40_000) and not chunking.klms_fits(58_113)
    with pytest.raises(ValueError, match="shared memory"):
        chunking.klms_tick_plan(58_113)
    assert chunking.feature_tile_grid(1024 * 16, 2048) == (128, 16)
    assert chunking.feature_tile_grid(7 * 5, 300) == (1, 3)
    with pytest.raises(ValueError, match="column tiles"):
        chunking.feature_tile_grid(1, 128 * 65_535 + 1)
    with pytest.raises(ValueError, match="rows"):
        chunking.feature_tile_grid(2 ** 31, 8)
    assert chunking.default_chunk_t(1024, 2048, 128) == 512
    assert chunking.default_chunk_t(1024, 60_000, 128) == 8


def test_klms_workspace_slabs():
    """A call's (B, T, D) feature workspace stays within its budget: the
    serving flush takes all 16 ticks at once, a 512-tick chunk of the
    same bank 32 ticks a slab, and a huge tenant one tick."""
    from repro_torch.kernels.rff_klms_step import (
        KLMS_WORKSPACE_BUDGET,
        klms_slab_ticks,
    )

    assert klms_slab_ticks(1024, 16, 2048) == 16
    assert klms_slab_ticks(1024, 512, 2048) == 32
    assert 4 * 1024 * 32 * 2048 <= KLMS_WORKSPACE_BUDGET
    assert klms_slab_ticks(100_000, 8, 58_000) == 1
    assert klms_slab_ticks(1, 3, 17) == 3


OPS_WITH_TILES = {
    "rff_features": dict(block_m=64, block_n=32, block_k=16),
    "rff_bank_predict": dict(block_b=2, block_q=8),
    "rff_klms_bank_step": dict(block_b=2),
    "rff_klms_bank_chunk": dict(block_b=2),
    "flash_attention": dict(block_q=16, block_k=16),
}


@pytest.mark.parametrize("name", sorted(OPS_WITH_TILES))
def test_ops_accept_repro_tiling_keywords(name):
    """Each op takes repro's tiling keywords and ignores them: the result
    equals the call without them."""
    a = _inputs(11, 5, 6, 40)
    t = {k: _t(v) for k, v in a.items()}
    args = {
        "rff_features": (t["xs"], t["w"], t["b"], t["s"]),
        "rff_bank_predict": (t["theta"], t["xs"], t["w"], t["b"], t["s"]),
        "rff_klms_bank_step": (t["theta"], t["xs"][:, 0].contiguous(),
                               t["ys"][:, 0].contiguous(), t["w"], t["b"],
                               t["mu"], t["s"]),
        "rff_klms_bank_chunk": (t["theta"], t["xs"], t["ys"], t["w"],
                                t["b"], t["mu"], t["mask"], t["s"]),
        "flash_attention": (t["xs"], t["xs"], t["xs"]),
    }[name]
    op = getattr(ops, name)
    want = op(*args, mode="auto")
    got = op(*args, mode="auto", **OPS_WITH_TILES[name])
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, w)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header it
    includes, directly or through another header: editing any of them
    names a new library, so it is rebuilt."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\nint f() { return 0; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\nconstexpr int kB = 1;\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources(tmp_path / "k.cu")] == [
        "k.cu", "a.cuh", "b.cuh"]
    names = {_build._target("k").name}
    (tmp_path / "b.cuh").write_text('#pragma once\nconstexpr int kB = 2;\n')
    names.add(_build._target("k").name)
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    names.add(_build._target("k").name)
    assert len(names) == 3
    monkeypatch.undo()
    for name in ("klms_bank", "bank_predict"):
        assert "feature_tile.cuh" in [
            p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]


def test_uniform_trig_scale_matches_repro_bitwise():
    """The f32-root rule, not the f64 root cast. The list holds D where the
    two roundings differ (15, 25, 33), D where PyTorch's CPU f32 sqrt is not
    correctly rounded (33, 132, ...), and the serving D."""
    for dfeat in [*range(1, 26), 33, 129, 132, 218, 300, 497, 528, 872,
                  1297, 1798, 2048]:
        want = np.asarray(jax_uniform_scale(dfeat))
        got = convert.to_numpy(uniform_trig_scale(dfeat))
        np.testing.assert_array_equal(got, want)


def test_convert_round_trips():
    a = _inputs(8, 4, 3, 20)
    tf = convert.trig_features(a["w"], a["b"], a["s"], device="cpu")
    for got, want in zip(tf, (a["w"], a["b"], a["s"])):
        np.testing.assert_array_equal(convert.to_numpy(got), want)
    tf_rff = convert.trig_features(a["w"], a["b"], device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(tf_rff.scale), a["s"])
    step = np.arange(4, dtype=np.int32)
    st = convert.lms_state(a["theta"], step, device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(st.theta), a["theta"])
    np.testing.assert_array_equal(convert.to_numpy(st.step), step)
    assert st.step.dtype == torch.int32
    pmat = np.stack([np.eye(20, dtype=np.float32) * (k + 1) for k in range(4)])
    rs = convert.rls_state(a["theta"], pmat, step, device="cpu")
    for got, want in zip(rs, (a["theta"], pmat, step)):
        np.testing.assert_array_equal(convert.to_numpy(got), want)
    assert rs.step.dtype == torch.int32


def test_mode_dispatch():
    a = _inputs(9, 3, 2, 16)
    args = [_t(a[k]) for k in ("theta", "xs", "w", "b")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rff_bank_predict(*args, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rff_klms_bank_chunk(args[0], args[1], _t(a["ys"]), *args[2:],
                                0.5, mode="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):  # repro's alias
        ops.rff_bank_predict(*args, mode="pallas")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        ops.rff_bank_predict(*args, mode="tpu")
    with pytest.raises(ValueError, match="unknown precision"):
        ops.rff_bank_predict(*args, precision="fp8")
    torch.testing.assert_close(
        ops.rff_bank_predict(*args, mode="ref"),
        ops.rff_bank_predict(*args, mode="auto"), atol=0, rtol=0,
    )


@pytest.mark.parametrize("orthogonal", [False, True])
def test_sampled_map_estimates_gaussian_kernel(orthogonal):
    """The port samples its own maps (a torch.Generator, not JAX's PRNG):
    the Monte-Carlo estimate approaches the Gaussian kernel."""
    gen = torch.Generator().manual_seed(0)
    rff = sample_rff(gen, 3, 8192, 1.5, orthogonal=orthogonal, device="cpu")
    rng = np.random.default_rng(10)
    x = _t(rng.normal(size=(32, 3)).astype(np.float32))
    y = _t(rng.normal(size=(32, 3)).astype(np.float32))
    err = (kernel_estimate(rff, x, y) - gaussian_kernel(x, y, 1.5)).abs()
    assert float(err.max()) < 0.05
    if orthogonal:
        block = rff.omega[:, :3]
        gram = block.T @ block
        off = gram - torch.diag(torch.diag(gram))
        assert float(off.abs().max()) < 1e-4

