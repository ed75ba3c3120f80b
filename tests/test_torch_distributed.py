"""The port's distribution tier (sharded RFF-KRLS and diffusion RFF-KLMS on
``torch.distributed``) held against ``repro`` on the CPU.

``repro`` runs its sharded step, block step, learner and diffusion on four
forced host devices in one subprocess (the device count locks when JAX
starts); its ``sharded_krls_run`` raises under the installed JAX, so the
port's run is held against a loop of ``repro``'s step (and block step) and
against ``repro``'s dense ``rff_krls_run``, as ``tests/test_krls_sharded.py``
holds the sharded run. The port runs in gloo process groups of four and
two CPU ranks (``tests/torch_dist_ranks.py``), concurrently with it; the
inputs are ``repro``'s draws (d = 5, D = 256, sigma = 5, lam = 1e-2, beta
= 0.9995, 600 ticks of ``gen_nonlinear_wiener`` at key 1; diffusion at
four nodes, D = 100, mu = 0.5, 600 ticks a node).

Tolerances (``tests/test_krls_sharded.py``, ``tests/test_chunked.py``):
1e-5 for the per-tick run and a step (the all_reduce sums the partials in
another order than the psum), 5e-5 for the k-tick blocks (the replay's
summation order), 1e-8 in float64 at lam = 1e-4, 1e-4 for a predict and
over a diffusion stream. What holds bit for bit: P's symmetry, the run
against its step and block-step functions, the quantizer, one all_reduce
a tick and one a block.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import quantize_int8 as jax_quantize_int8
from repro.core.klms import rff_klms_run as jax_rff_klms_run
from repro.core.krls import rff_krls_run as jax_rff_krls_run
from repro.core.rff import rff_features as jax_rff_features
from repro.core.rff import sample_rff
from repro.data.synthetic import gen_nonlinear_wiener
from repro.launch.sharding import krls_shard_bytes as jax_krls_shard_bytes
from repro_torch import convert
from repro_torch.core.distributed import dequantize_int8, quantize_int8
from repro_torch.core.klms import rff_klms_run
from repro_torch.core.krls import rff_krls_run
from repro_torch.launch.mesh import make_krls_mesh
from repro_torch.launch.sharding import krls_shard_bytes

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_ranks.py"
STEP_TOL, BLOCK_TOL, F64_TOL, STREAM_TOL = 1e-5, 5e-5, 1e-8, 1e-4
D_IN, D_FEAT, N, LAM, BETA = 5, 256, 600, 1e-2, 0.9995
NODES, D_DIFF, MU = 4, 100, 0.5
CUT = 300  # a repro state at this tick is carried onto the port's mesh
F64_N = 300  # float64 ticks (tests/test_chunked.py's stream)
DIFFUSION_RUNS = [(1, 0), (10**9, 0), (1, 1)]  # (combine_every, compress)
HEAD = 3  # combines over which the int8 run is held tick by tick

_REPRO_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import diffusion_klms_run
from repro.core.krls import (make_sharded_krls_block_step,
    make_sharded_krls_step, sharded_krls_init)
from repro.core.learner import sharded_krls_learner
from repro.core.rff import RFF

inp = dict(np.load(sys.argv[1]))
out = {}
blocks_only = sys.argv[3:] == ["32"]  # the k = 32 replay compiles alone
rff = RFF(omega=jnp.asarray(inp["omega"]), bias=jnp.asarray(inp["bias"]))
xs, ys = jnp.asarray(inp["xs"]), jnp.asarray(inp["ys"])
lam, beta, n = float(inp["lam"]), float(inp["beta"]), xs.shape[0]
mesh = jax.make_mesh((4,), ("shard",))
step = make_sharded_krls_step(mesh, rff, beta)
state = sharded_krls_init(mesh, rff.num_features, lam)
preds = []
for t in range(0 if blocks_only else n):
    state, o = step(state, xs[t], ys[t])
    preds.append(np.asarray(o.prediction))
if not blocks_only:
    out["step_pred"] = np.stack(preds)
    out["step_pmat"] = np.asarray(state.pmat)
for k in [int(k) for k in sys.argv[3:]]:
    block = make_sharded_krls_block_step(mesh, rff, beta, combine_every=k)
    state = sharded_krls_init(mesh, rff.num_features, lam)
    preds = []
    for start in range(0, n - n % k, k):
        state, o = block(state, xs[start:start + k], ys[start:start + k])
        preds.append(np.asarray(o.prediction))
    out[f"block_pred_k{k}"] = np.concatenate(preds)
if blocks_only:
    np.savez(sys.argv[2], **out)
    sys.exit(0)
lrn = sharded_krls_learner(mesh, rff, lam=lam, beta=beta)
state = lrn.init()
preds = []
for t in range(32):
    state, o = lrn.step(state, xs[t], ys[t])
    preds.append(np.asarray(o.prediction))
out["learner_pred"] = np.stack(preds)
out["learner_predict"] = np.asarray(lrn.predict(state, xs[40]))

dmesh = jax.make_mesh((4,), ("data",))
drff = RFF(omega=jnp.asarray(inp["d_omega"]), bias=jnp.asarray(inp["d_bias"]))
for i, (every, compress) in enumerate(inp["runs"]):
    theta, errs = diffusion_klms_run(
        dmesh, "data", drff, jnp.asarray(inp["d_xs"]),
        jnp.asarray(inp["d_ys"]), mu=float(inp["mu"]),
        combine_every=int(every), compress=bool(compress))
    out[f"theta_run{i}"] = np.asarray(theta)
    out[f"errs_run{i}"] = np.asarray(errs)
head = int(inp["head"])
theta, _ = diffusion_klms_run(
    dmesh, "data", drff, jnp.asarray(inp["d_xs"][:, :head]),
    jnp.asarray(inp["d_ys"][:, :head]), mu=float(inp["mu"]), combine_every=1,
    compress=True)
out["head_theta"] = np.asarray(theta)
np.savez(sys.argv[2], **out)
"""


def _start(argv, env):
    return subprocess.Popen([str(a) for a in argv], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs and dense runs in this process; repro's four-device runs (the
    k = 32 block step, whose unrolled replay compiles for ~20 s, in a
    process of its own) and the port's three spawns (sharded KRLS on four
    ranks and on two, diffusion on four), all side by side."""
    tmp = tmp_path_factory.mktemp("distributed")
    rff = sample_rff(jax.random.PRNGKey(0), D_IN, D_FEAT, sigma=5.0)
    xs, ys = gen_nonlinear_wiener(jax.random.PRNGKey(1), num_samples=N)
    drff = sample_rff(jax.random.PRNGKey(0), D_IN, D_DIFF, sigma=5.0)
    dxs, dys = gen_nonlinear_wiener(jax.random.PRNGKey(1),
                                    num_samples=N * NODES)
    cut_state, _ = jax_rff_krls_run(rff, xs[:CUT], ys[:CUT], lam=LAM,
                                    beta=BETA)
    inp = dict(
        omega=np.asarray(rff.omega), bias=np.asarray(rff.bias),
        xs=np.asarray(xs), ys=np.asarray(ys), lam=LAM, beta=BETA,
        lams=np.array([LAM]), ks=np.array([1, 8, 32]), gather_p=1,
        f64_lams=np.array([1e-4]), f64_ks=np.array([1, 8]), f64_ticks=F64_N,
        cut=CUT,
        ref_theta_cut=np.asarray(cut_state.theta),
        ref_pmat_cut=np.asarray(cut_state.pmat),
        ref_step_cut=np.asarray(cut_state.step),
        d_omega=np.asarray(drff.omega), d_bias=np.asarray(drff.bias),
        d_xs=np.asarray(dxs).reshape(NODES, N, D_IN),
        d_ys=np.asarray(dys).reshape(NODES, N), mu=MU,
        runs=np.array(DIFFUSION_RUNS), head=HEAD,
    )
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        "ref": _start([sys.executable, "-c", _REPRO_SCRIPT, tmp / "in.npz",
                       tmp / "ref.npz", 8], env),
        "ref32": _start([sys.executable, "-c", _REPRO_SCRIPT, tmp / "in.npz",
                         tmp / "ref32.npz", 32], env),
        "port4": _start([sys.executable, WORKER, 4, "cpu", "parity",
                         tmp / "in.npz", tmp / "port4.npz"], env),
        "port4d": _start([sys.executable, WORKER, 4, "cpu", "diffusion",
                          tmp / "in.npz", tmp / "port4d.npz"], env),
        "port2": _start([sys.executable, WORKER, 2, "cpu", "krls",
                         tmp / "in.npz", tmp / "port2.npz"], env),
    }
    try:
        errs = {name: p.communicate(timeout=300)[1]
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name}: {errs[name][-3000:]}"
    _, dense = jax_rff_krls_run(rff, xs, ys, lam=LAM, beta=BETA)
    ref = dict(np.load(tmp / "ref.npz"), **np.load(tmp / "ref32.npz"))
    return dict(inp=inp, ref=ref,
                port={4: dict(np.load(tmp / "port4.npz"),
                              **np.load(tmp / "port4d.npz")),
                      2: dict(np.load(tmp / "port2.npz"))},
                dense=np.asarray(dense.prediction))


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_run_matches_repro_step_loop_and_dense(runs, world):
    """Per tick (one all_reduce each) within 1e-5 of repro's dense run at
    n in {2, 4} and of repro's sharded step loop (n = 4)."""
    pred = runs["port"][world]["pred_lam0_k1"]
    assert pred.shape == (N,)
    assert _maxdiff(pred, runs["dense"]) < STEP_TOL
    assert _maxdiff(pred, runs["ref"]["step_pred"]) < STEP_TOL


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("k", [8, 32])
def test_blocks_match_per_tick_and_dense(runs, world, k):
    """combine_every = k: within 5e-5 of the per-tick run and the dense run
    (k = 32 leaves a 24-tick tail block), and of repro's block step on the
    whole blocks."""
    port = runs["port"][world]
    pred = port[f"pred_lam0_k{k}"]
    assert pred.shape == (N,)
    assert _maxdiff(pred, port["pred_lam0_k1"]) < BLOCK_TOL
    assert _maxdiff(pred, runs["dense"]) < BLOCK_TOL
    ref = runs["ref"][f"block_pred_k{k}"]
    assert _maxdiff(pred[:len(ref)], ref) < BLOCK_TOL
    assert int(port[f"step_lam0_k{k}"]) == N


@pytest.mark.parametrize("k", [1, 8])
def test_float64_sharded_matches_dense(runs, k):
    """At the paper's lam = 1e-4 in float64 the restructuring is exact
    math: the sharded run (per tick and in blocks of 8) over 300 ticks
    within 1e-8 of the port's dense run."""
    inp = runs["inp"]
    tf = convert.trig_features(inp["omega"], inp["bias"], device="cpu")
    tf = type(tf)(*(a.double() for a in tf))
    xs = torch.tensor(inp["xs"][:F64_N], dtype=torch.float64)
    ys = torch.tensor(inp["ys"][:F64_N], dtype=torch.float64)
    _, dense = rff_krls_run(tf, xs, ys, lam=1e-4, beta=BETA)
    pred = runs["port"][4][f"pred_f64_lam0_k{k}"]
    assert pred.dtype == np.float64
    assert _maxdiff(pred, dense.prediction.numpy()) < F64_TOL


@pytest.mark.parametrize("world", [2, 4])
def test_one_all_reduce_a_tick_and_a_block(runs, world):
    """Counted through a wrapped ``dist.all_reduce``: 600 ticks are 600
    all_reduces per tick, 75 in blocks of 8, 19 in blocks of 32 (the
    tail's one among them); a step, a block step and a predict one each."""
    port = runs["port"][world]
    assert int(port["count_lam0_k1"]) == N
    assert int(port["count_lam0_k8"]) == N // 8
    assert int(port["count_lam0_k32"]) == -(-N // 32)
    if world == 4:
        assert int(port["count_f64_lam0_k1"]) == F64_N
        assert int(port["step_calls"]) == 1
        assert int(port["predict_calls"]) == 1


@pytest.mark.parametrize("k", [1, 8, 32])
def test_p_stays_bitwise_symmetric(runs, k):
    """The gathered P equals its transpose bit for bit after the stream
    (no re-symmetrization pass), and the per-tick P is within 1e-4 of
    max|P| (normwise, as KRLS's P is held elsewhere) of repro's."""
    pmat = runs["port"][4][f"pmat_lam0_k{k}"]
    assert pmat.shape == (D_FEAT, D_FEAT)
    assert np.array_equal(pmat, pmat.T)
    if k == 1:
        want = runs["ref"]["step_pmat"]
        assert _maxdiff(pmat, want) < 1e-4 * np.max(np.abs(want))


def test_step_and_block_functions_equal_the_run(runs):
    """make_sharded_krls_step over 64 ticks is the per-tick run bit for
    bit (predictions and P), the block step over 75 blocks of 8 the
    blocked run."""
    port = runs["port"][4]
    assert bool(port["step_equals_run"])
    assert bool(port["block_step_equals_run"])
    assert int(port["block_step_count"]) == N - N % 8


def test_learner_matches_repro(runs):
    """sharded_krls_learner: 32 steps within 1e-5, a predict within 1e-4
    of repro's adapter; the run's predict (kernel 3's partials, one
    all_reduce) within 1e-4 of the dense read, for one query and eight."""
    port, ref = runs["port"][4], runs["ref"]
    assert _maxdiff(port["learner_pred"], ref["learner_pred"]) < STEP_TOL
    assert _maxdiff(port["learner_predict"], ref["learner_predict"]) < 1e-4
    inp = runs["inp"]
    rff = sample_rff(jax.random.PRNGKey(0), D_IN, D_FEAT, sigma=5.0)
    state, _ = jax_rff_krls_run(rff, jnp.asarray(inp["xs"]),
                                jnp.asarray(inp["ys"]), lam=LAM, beta=BETA)
    z = jax_rff_features(rff, jnp.asarray(inp["xs"][40:48]))
    want = np.asarray(z @ state.theta)
    assert port["run_predict"].shape == ()
    assert _maxdiff(port["run_predict"], want[0]) < 1e-4
    assert port["run_predict_block"].shape == (8,)
    assert _maxdiff(port["run_predict_block"], want) < 1e-4


def test_state_and_feature_placements(runs):
    """State leaves are DTensors of the global shape: theta and P Shard(0),
    step Replicate(); omega Shard(1), bias and scale Shard(0); each rank
    holds (D/4, D) of P. Diffusion's outputs are Shard(0)."""
    port = runs["port"][4]
    assert bool(port["state_placements_ok"])
    assert bool(port["feature_placements_ok"])
    for i in range(len(DIFFUSION_RUNS)):
        assert str(port[f"placements_run{i}"]) == (
            "((Shard(dim=0),), (Shard(dim=0),))")


def test_repro_state_carried_onto_the_mesh(runs):
    """repro's state after 300 ticks, placed row-sharded through
    convert.sharded_rls_state, runs ticks 300-599 within 1e-5 of repro's
    dense run; the caller's state is left as it was."""
    port = runs["port"][4]
    assert _maxdiff(port["carried_pred"], runs["dense"][CUT:]) < STEP_TOL
    assert int(port["carried_step"]) == N
    assert bool(port["carried_input_kept"])


def test_sharded_raises_as_repro(runs):
    """Taylor has no column decomposition (TypeError), D must divide the
    shard count (ValueError), and diffusion runs one node a rank: 8 nodes
    on 4 ranks raise (repro silently drops the extra nodes)."""
    port = runs["port"][4]
    assert str(port["raise_taylor"]) == "TypeError"
    assert str(port["raise_divide"]) == "ValueError"
    assert str(port["raise_nodes"]) == "ValueError"


def test_make_krls_mesh_needs_a_process_group():
    """No backend is chosen for the caller: without an initialized process
    group the mesh raises."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_krls_mesh(device_type="cpu")


@pytest.mark.parametrize("dfeat,shards,d,itemsize", [
    (4096, 8, 16, 4), (256, 4, 5, 4), (32768, 4, 5, 4), (300, 3, 5, 8),
    (1024, 1, 0, 4),
])
def test_krls_shard_bytes_matches_repro(dfeat, shards, d, itemsize):
    assert krls_shard_bytes(dfeat, shards, d, itemsize) == (
        jax_krls_shard_bytes(dfeat, shards, d, itemsize))
    with pytest.raises(ValueError):
        krls_shard_bytes(dfeat + 1, 2 * shards if shards > 1 else 3)


@pytest.mark.parametrize("run", [0, 1, 2])
def test_diffusion_matches_repro(runs, run):
    """The first tick's errors within 1e-5 of repro's. Combining every tick
    and never: every error and the final thetas within 1e-4 over the
    600-tick streams. Compressed: int8 rounding is not continuous, so a
    message one ulp apart can land one level (max|msg| / 127) apart and
    the two runs part (here from the fourth combine, tick 4's errors
    1.4e-5 apart). So the int8 run is held within 1e-5 of repro's over its
    first three combines, the last two carrying the error-feedback
    residual: a 3-tick run's thetas and the errors of ticks 0-3, which
    read them. There it lies over 1e-4 from the uncompressed run, so the
    quantizer did run. Over the stream it is held by its tail MSE, within
    1% of repro's (and by the bounds below)."""
    port, ref = runs["port"][4], runs["ref"]
    errs, want = port[f"errs_run{run}"], ref[f"errs_run{run}"]
    theta = port[f"theta_run{run}"]
    assert errs.shape == want.shape == (NODES, N)
    assert theta.shape == (NODES, D_DIFF)
    assert _maxdiff(errs[:, 0], want[:, 0]) < STEP_TOL
    if DIFFUSION_RUNS[run][1]:
        head = HEAD + 1  # tick HEAD reads the last held combine
        assert port["head_theta"].shape == (NODES, D_DIFF)
        assert _maxdiff(port["head_theta"], ref["head_theta"]) < STEP_TOL
        assert _maxdiff(errs[:, :head], want[:, :head]) < STEP_TOL
        assert _maxdiff(errs[:, :head],
                        port["errs_run0"][:, :head]) > 10 * STEP_TOL
        mse = float(np.mean(errs[:, -100:] ** 2))
        assert abs(mse / float(np.mean(want[:, -100:] ** 2)) - 1) < 1e-2
    else:
        assert _maxdiff(errs, want) < STREAM_TOL
        assert _maxdiff(theta, ref[f"theta_run{run}"]) < STREAM_TOL


def test_diffusion_combining_every_tick_keeps_nodes_equal(runs):
    theta = runs["port"][4]["theta_run0"]
    assert float(np.max(np.abs(theta - theta[0:1]))) == 0.0


def test_diffusion_never_combining_is_independent_runs(runs):
    """combine_every = 10**9: each node is its own rff_klms_run (the
    port's, within 1e-5: the chunk featurizes in one product)."""
    inp, port = runs["inp"], runs["port"][4]
    tf = convert.trig_features(inp["d_omega"], inp["d_bias"], device="cpu")
    for node in range(NODES):
        state, out = rff_klms_run(tf, torch.tensor(inp["d_xs"][node]),
                                  torch.tensor(inp["d_ys"][node]), MU)
        assert _maxdiff(port["errs_run1"][node], out.error.numpy()) < 1e-5
        assert _maxdiff(port["theta_run1"][node], state.theta.numpy()) < 1e-5


def test_diffusion_tail_mse_bounds(runs):
    """tests/test_distributed.py's claims on the port's runs: cooperation
    helps (within 5% of the isolated floor) and the int8 error-feedback
    combine lands within 1.5x of the uncompressed one."""
    port = runs["port"][4]
    mse = [float(np.mean(port[f"errs_run{i}"][:, -100:] ** 2))
           for i in range(3)]
    assert mse[0] <= mse[1] * 1.05
    assert mse[2] <= mse[0] * 1.5


def test_quantizer_matches_repro_bitwise():
    """quantize_int8 and dequantize_int8 on fixed vectors, exact ties
    among them (both round half to even), bit for bit repro's."""
    rng = np.random.default_rng(3)
    cases = [
        np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -127.0]),
        rng.normal(size=256),
        rng.normal(size=100) * 1e-3,
        np.zeros(8),
    ]
    for v in cases:
        v = v.astype(np.float32)
        q, scale = quantize_int8(torch.from_numpy(v))
        jq, jscale = jax_quantize_int8(jnp.asarray(v))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
        deq = dequantize_int8(q, scale)
        assert deq.numpy().tobytes() == np.asarray(
            jq.astype(jnp.float32) * jscale).tobytes()


def test_never_combining_repro_stream_is_independent_runs(runs):
    """The reference's own claim behind the previous test: repro's
    never-combining diffusion equals its rff_klms_run per node (1e-5)."""
    inp = runs["inp"]
    drff = sample_rff(jax.random.PRNGKey(0), D_IN, D_DIFF, sigma=5.0)
    for node in range(NODES):
        _, out = jax_rff_klms_run(drff, jnp.asarray(inp["d_xs"][node]),
                                  jnp.asarray(inp["d_ys"][node]), MU)
        assert _maxdiff(runs["ref"]["errs_run1"][node], out.error) < 1e-5
