"""The port's KLMS serving slice held against ``repro`` on the CPU.

Both packages get the same feature map (sampled by ``repro``, carried over
with ``repro_torch.convert``) and the same ragged stream of submits,
flushes and reads, made with ``np.random.default_rng``. ``repro`` runs its
oracle path (``mode="xla"``); the port runs on ``device="cpu"``, where
every kernel is its plain PyTorch version.

Tolerances:
* 1e-4 for the whole slice over several flushes: XLA and PyTorch sum the
  projection and the theta . z reduction in different orders and their
  cos differ by an ulp, and the LMS recursion carries each tick's
  difference into every later tick (one step or chunk holds at 1e-5 in
  tests/test_torch_kernels.py).
* bf16 reads: 2e-2 (tests/test_read_path.py), each against its own f32
  read, and port-bf16 against repro-bf16.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.features.base import as_trig as jax_as_trig
from repro.features.random import rff_map as jax_rff_map
from repro.serve import api as japi
from repro.serve.metrics import Histogram as JaxHistogram
from repro_torch import convert
from repro_torch.serve import api
from repro_torch.serve.metrics import Histogram

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SLICE_TOL = 1e-4
BF16_TOL = 2e-2
B, D_IN, D_FEAT = 12, 5, 96


def _maps(seed=0, d=D_IN, dfeat=D_FEAT):
    jtf = jax_as_trig(jax_rff_map(jax.random.PRNGKey(seed), d, dfeat, 2.0))
    ttf = convert.trig_features(
        np.asarray(jtf.omega), np.asarray(jtf.bias), np.asarray(jtf.scale),
        device="cpu",
    )
    return jtf, ttf


def _servers(**kw):
    jtf, ttf = _maps()
    jsrv = japi.make_server("klms", feature_map=jtf, bank=B, mode="xla", **kw)
    tsrv = api.make_server("klms", feature_map=ttf, bank=B, device="cpu",
                           **kw)
    return jsrv, tsrv


def _stream(seed, n):
    """Ragged arrivals: skewed tenant choice, tenants 10 and 11 idle."""
    rng = np.random.default_rng(seed)
    p = np.array([8, 6, 5, 4, 3, 3, 2, 2, 1, 1, 0, 0], float)
    tenants = rng.choice(B, size=n, p=p / p.sum())
    xs = rng.normal(size=(n, D_IN)).astype(np.float32)
    ys = np.sin(0.5 * xs[:, 0]) + 0.3 * xs[:, 1] + 0.05 * rng.normal(size=n)
    return tenants, xs, ys.astype(np.float32)


def _close(got, want, tol=SLICE_TOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        atol=tol, rtol=tol,
    )


def _flush_results_close(jres, tres):
    assert sorted(jres) == sorted(tres)
    for tenant in jres:
        _close(np.asarray(tres[tenant]), np.asarray(jres[tenant]))


def test_klms_server_matches_repro():
    """The slice end to end: submits, flushes, drain, every read."""
    jsrv, tsrv = _servers(chunk=4)
    tenants, xs, ys = _stream(0, 240)
    errs = []
    for start in range(0, 240, 40):
        for i in range(start, start + 40):
            jsrv.submit(int(tenants[i]), xs[i], ys[i])
            tsrv.submit(int(tenants[i]), xs[i], ys[i])
        jres, tres = jsrv.flush(), tsrv.flush()
        _flush_results_close(jres, tres)
        errs.append(np.mean([e**2 for r in tres.values() for _, e in r]))
    _flush_results_close(jsrv.drain(), tsrv.drain())
    assert errs[-1] < errs[0]  # the filter learns
    assert tsrv.staleness == jsrv.staleness == 0
    assert tsrv.snapshot.version == jsrv.snapshot.version
    _close(tsrv.snapshot.state.theta, jsrv.snapshot.state.theta)
    np.testing.assert_array_equal(
        convert.to_numpy(tsrv.snapshot.state.step),
        np.asarray(jsrv.snapshot.state.step),
    )

    rng = np.random.default_rng(1)
    xq = rng.normal(size=(B, 7, D_IN)).astype(np.float32)
    for tenant in (0, 3, 11):
        _close(tsrv.predict(tenant, xq[tenant, 0]),
               jsrv.predict(tenant, xq[tenant, 0]))
        _close(tsrv.predict(tenant, xq[tenant]),
               jsrv.predict(tenant, xq[tenant]))
    t32, j32 = tsrv.predict_block(xq), jsrv.predict_block(xq)
    _close(t32, j32)
    for srv in (jsrv, tsrv):
        srv.snapshot_server.precision = "bf16"
    t16, j16 = tsrv.predict_block(xq), jsrv.predict_block(xq)
    _close(t16, j16, BF16_TOL)
    assert 0 < float((t16 - t32).abs().max()) < BF16_TOL
    assert float(np.abs(np.asarray(j16) - np.asarray(j32)).max()) < BF16_TOL
    assert tsrv.metrics.count("requests.write") == 240
    assert tsrv.metrics.count("requests.read") == 8


@pytest.mark.parametrize("chunk", [None, 4])
def test_run_stream_matches_repro(chunk):
    """Lockstep streams through the step kernel (chunk=None) or the
    chunk kernel with a masked remainder (chunk=4 over 10 ticks)."""
    jtf, ttf = _maps(1)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(6, 10, D_IN)).astype(np.float32)
    ys = np.cos(xs.sum(-1)).astype(np.float32)
    jstate, jout = japi.run_stream("klms", jtf, xs, ys, mode="xla",
                                   chunk=chunk, mu=0.3)
    tstate, tout = api.run_stream(
        "klms", ttf, convert.tensor(xs, device="cpu"),
        convert.tensor(ys, device="cpu"), chunk=chunk, mu=0.3,
    )
    _close(tstate.theta, jstate.theta)
    _close(tout.prediction, jout.prediction)
    _close(tout.error, jout.error)
    np.testing.assert_array_equal(convert.to_numpy(tstate.step),
                                  np.asarray(jstate.step))


def test_adaptive_queue_power_of_two_chunks():
    jsrv, tsrv = _servers(chunk=16, adaptive=True)
    rng = np.random.default_rng(3)
    for depth, want_t in ((3, 4), (1, 1), (5, 8), (16, 16), (20, 16)):
        for _ in range(depth):
            x = rng.normal(size=D_IN).astype(np.float32)
            for srv in (jsrv, tsrv):
                srv.submit(2, x, 0.5)
        assert tsrv.queue._flush_chunk() == want_t
        _flush_results_close(jsrv.flush(), tsrv.flush())
        jsrv.drain()
        tsrv.drain()
    _close(tsrv.snapshot.state.theta, jsrv.snapshot.state.theta)


def test_publish_every_two_staleness():
    """A non-publishing flush leaves the replica's theta unchanged; the
    second tick publishes."""
    jsrv, tsrv = _servers(chunk=4, publish_every=2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=D_IN).astype(np.float32)
    for srv in (jsrv, tsrv):
        srv.submit(0, x, 1.0)
    before = tsrv.snapshot.state.theta.clone()
    jsrv.flush()
    tsrv.flush()
    assert tsrv.staleness == jsrv.staleness == 1
    assert tsrv.snapshot.version == jsrv.snapshot.version == 0
    assert torch.equal(tsrv.snapshot.state.theta, before)
    assert not torch.equal(tsrv.queue.state.theta, before)
    x = rng.normal(size=D_IN).astype(np.float32)
    for srv in (jsrv, tsrv):
        srv.submit(0, x, -1.0)
        srv.flush()
    assert tsrv.staleness == jsrv.staleness == 0
    assert tsrv.snapshot.version == jsrv.snapshot.version == 1
    assert torch.equal(tsrv.snapshot.state.theta, tsrv.queue.state.theta)
    _close(tsrv.snapshot.state.theta, jsrv.snapshot.state.theta)


def test_watermarks_and_stale_watchdog():
    now = [0.0]
    jtf, ttf = _maps()
    srv = api.make_server("klms", feature_map=ttf, bank=B, device="cpu",
                          size_watermark=3, age_watermark=5.0,
                          clock=lambda: now[0])
    x = np.ones(D_IN, np.float32)
    srv.submit(1, x, 1.0)
    srv.submit(1, x, 1.0)
    assert srv.queue.flushes == 0
    srv.submit(1, x, 1.0)  # backlog 3 trips the size watermark
    assert srv.queue.flushes == 1 and sum(srv.queue.backlog()) == 0
    srv.submit(4, x, 1.0)
    now[0] = 4.9
    assert srv.maybe_flush() == {}
    now[0] = 5.0
    assert list(srv.maybe_flush()) == [4]
    queue = api.make_queue("klms", ttf, B, device="cpu")
    queue.stale_after, queue._clock = 1.0, lambda: now[0]
    queue.submit(7, x, 1.0)
    assert not queue.has_stale()
    now[0] = 6.5
    assert list(queue.maybe_flush()) == [7] and queue.stale_flushes == 1


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ttf = _maps()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        api.make_server("klms", feature_map=ttf, bank=2)


# The baselines' serving hyperparameters: ALD at sigma = 1, where f32 is
# well conditioned (at sigma = 5 f32 itself is the limit,
# tests/test_torch_learners.py).
FAMILY_HP = {
    "nklms": dict(mu=0.5),
    "qklms": dict(sigma=1.0, mu=0.5, quant_eps=1.0, capacity=32),
    "ald": dict(sigma=1.0, nu=5e-3, capacity=32),
}


def _family_servers(learner, **kw):
    jtf, ttf = _maps()
    hp = dict(FAMILY_HP[learner], bank=B, chunk=4, **kw)
    if learner == "nklms":
        return (japi.make_server(learner, feature_map=jtf, mode="xla", **hp),
                api.make_server(learner, feature_map=ttf, device="cpu", **hp))
    return (japi.make_server(learner, input_dim=D_IN, **hp),
            api.make_server(learner, input_dim=D_IN, device="cpu", **hp))


def _state_close(tstate, jstate):
    for name, t, j in zip(tstate._fields, tstate, jstate):
        if t.dtype == torch.int32 or name == "centers":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j)


@pytest.mark.parametrize("learner", ["nklms", "qklms", "ald"])
def test_learner_server_matches_repro(learner):
    """The baselines and NKLMS served end to end against ``repro``'s
    ``make_server``: a ragged stream of submits and flushes, the bank
    state, single-tenant and block reads, all at 1e-4."""
    jsrv, tsrv = _family_servers(learner)
    tenants, xs, ys = _stream(0, 240)
    for start in range(0, 240, 40):
        for i in range(start, start + 40):
            jsrv.submit(int(tenants[i]), xs[i], ys[i])
            tsrv.submit(int(tenants[i]), xs[i], ys[i])
        _flush_results_close(jsrv.flush(), tsrv.flush())
    _flush_results_close(jsrv.drain(), tsrv.drain())
    _state_close(tsrv.snapshot.state, jsrv.snapshot.state)
    rng = np.random.default_rng(1)
    xq = rng.normal(size=(B, 7, D_IN)).astype(np.float32)
    for tenant in (0, 3, 11):
        _close(tsrv.predict(tenant, xq[tenant, 0]),
               jsrv.predict(tenant, xq[tenant, 0]))
        _close(tsrv.predict(tenant, xq[tenant]),
               jsrv.predict(tenant, xq[tenant]))
    _close(tsrv.predict_block(xq), jsrv.predict_block(xq))
    assert tsrv.predict_block(xq).shape == (B, 7)
    assert tsrv.metrics.count("requests.read") == 8


@pytest.mark.parametrize("learner", ["nklms", "qklms", "ald"])
def test_learner_server_lifecycle(learner):
    """Evict two tenants, keep logging their arrivals, readmit them
    sequentially: the dictionary learners equal a never-evicted control
    bit for bit (NKLMS within the replay bound 5e-5), untouched tenants
    are bit for bit the control's, and the result matches ``repro``'s
    server at 1e-4. A masked tick changes no bit; reset_tenant parks a
    fresh row."""
    jsrv, tsrv = _family_servers(learner, log_capacity=64,
                                 rebuild_mode="sequential")
    _, ctl = _family_servers(learner)
    tenants, xs, ys = _stream(2, 200)

    def feed(lo, hi):
        for srv in (jsrv, tsrv, ctl):
            for i in range(lo, hi):
                srv.submit(int(tenants[i]), xs[i], ys[i])
            srv.drain()

    feed(0, 120)
    for srv in (jsrv, tsrv):
        srv.evict(0)
        srv.evict(2)
    assert float(tsrv.snapshot.state[0][0].abs().max()) == 0.0
    feed(120, 200)
    for srv in (jsrv, tsrv):
        assert srv.readmit(0) == int((tenants == 0).sum())
        srv.readmit(2)
    for got, want in zip(tsrv.queue.state, ctl.queue.state):
        assert torch.equal(got[3:], want[3:]) and torch.equal(got[1], want[1])
        if learner == "nklms":
            rel = float((got[:3].double() - want[:3].double()).norm()
                        / want[:3].double().norm())
            assert rel <= 5e-5
        else:
            assert torch.equal(got, want)
    _state_close(tsrv.snapshot.state, jsrv.snapshot.state)
    before = tsrv.queue.state
    tsrv.submit(5, xs[0], ys[0])
    tsrv.flush()
    for a, b in zip(before, tsrv.queue.state):
        assert torch.equal(torch.cat([a[:5], a[6:]]),
                           torch.cat([b[:5], b[6:]]))
    assert tsrv.reset_tenant(5) == 0
    assert all(not bool(a[5].any()) for a in tsrv.queue.state)


@pytest.mark.parametrize("knob", [
    dict(trace=True), dict(probe=True),
    dict(recovery=True), dict(wal="wal.jsonl"),
])
def test_unported_knob_raises(knob, tmp_path, monkeypatch):
    """These knobs raised until ROADMAP §1 entry 5 ported them (the name is
    kept): each now builds a server in repro's form that serves."""
    monkeypatch.chdir(tmp_path)
    _, ttf = _maps()
    srv = api.make_server("klms", feature_map=ttf, device="cpu", **knob)
    rng = np.random.default_rng(1)
    for t in range(4):
        srv.submit(t, rng.normal(size=D_IN).astype(np.float32), 1.0)
    srv.drain()
    assert srv.queue.ticks_served == 4
    name = next(iter(knob))
    attr = {"trace": "tracer", "probe": "probe", "recovery": "recovery",
            "wal": "wal"}[name]
    assert getattr(srv, attr) is not None
    if name == "wal":
        assert len(srv.wal.entries()) == 4
        srv.wal.close()


def test_unported_lifecycle_and_unknown_names():
    """Without a replay log, evict parks a fresh row and readmit restarts
    the tenant cold on it (repro/serve/snapshot.py:372-420)."""
    _, ttf = _maps()
    srv = api.make_server("klms", feature_map=ttf, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(5):
        srv.submit(0, rng.normal(size=D_IN), 1.0)
    srv.drain()
    assert float(srv.snapshot.state.theta[0].abs().max()) > 0.0
    assert srv.evict(0) == 0 and srv.evicted == frozenset({0})
    assert srv.snapshot_server.log is None
    assert float(srv.snapshot.state.theta[0].abs().max()) == 0.0
    assert srv.readmit(0) == 0 and srv.evicted == frozenset()
    assert float(srv.snapshot.state.theta[0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown learner"):
        api.make_server("svm", feature_map=ttf, device="cpu")
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        api.make_server("klms", feature_map=ttf, device="cpu",
                        learning_rate=0.1)


def test_histogram_matches_repro():
    rng = np.random.default_rng(5)
    obs = np.concatenate([rng.exponential(3e-3, 500), [0.0, 7.5e5]])
    ours, theirs = Histogram(), JaxHistogram()
    for v in obs:
        ours.observe(v)
        theirs.observe(v)
    assert ours.summary() == theirs.summary()


# The training half's modules, which the walk below must reach.
TRAINING_MODULES = ("repro_torch.optim", "repro_torch.optim.optimizers",
                    "repro_torch.optim.schedules",
                    "repro_torch.optim.compression", "repro_torch.optim.tree",
                    "repro_torch.train.steps", "repro_torch.train.trainer",
                    "repro_torch.train.checkpoint", "repro_torch.train.elastic",
                    "repro_torch.data.lm_data", "repro_torch.launch.train")


def test_import_hygiene():
    """repro_torch (the training half's modules among the ones imported),
    chip_smoke.py and dist_smoke.py import neither jax nor repro."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [n for n in {TRAINING_MODULES!r} if n not in sys.modules]\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for script in ("chip_smoke.py", "dist_smoke.py"):
        text = (ROOT / script).read_text()
        imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", text, re.M)
        assert imports, f"{script} has no imports?"
        assert not [m for m in imports if m.split(".")[0] in ("jax", "repro")]
        assert not re.search(r"\bjax\b", text)


def _serve_same_stream(*servers, seed=7, n=120):
    tenants, xs, ys = _stream(seed, n)
    for srv in servers:
        for i in range(n):
            srv.submit(int(tenants[i]), xs[i], ys[i])
        srv.drain()
    return xs


def test_input_dim_follows_repro():
    """input_dim= is taken by make_tick, make_chunk_step, make_queue,
    run_stream and make_server with repro's rule: the feature map's width
    wins and input_dim is ignored. The RFF families need a map; a
    dictionary learner is served from input_dim alone."""
    jtf, ttf = _maps()
    wide = api.make_server("klms", feature_map=ttf, bank=B, device="cpu",
                           input_dim=D_IN + 7)
    plain = api.make_server("klms", feature_map=ttf, bank=B, device="cpu")
    jsrv = japi.make_server("klms", feature_map=jtf, bank=B, mode="xla",
                            input_dim=D_IN + 7)
    xs = _serve_same_stream(wide, plain, jsrv)
    assert torch.equal(wide.snapshot.state.theta, plain.snapshot.state.theta)
    _close(wide.snapshot.state.theta, jsrv.snapshot.state.theta)
    xq = np.stack([xs[:3]] * B)
    assert torch.equal(wide.predict_block(xq), plain.predict_block(xq))
    kw = dict(input_dim=99, mode="ref")
    state = plain.queue.state
    x0 = convert.tensor(xs[:B], device="cpu")
    y0 = convert.tensor(np.ones(B, np.float32), device="cpu")
    for a, b in zip(api.make_tick("klms", ttf, **kw)(state, x0, y0),
                    api.make_tick("klms", ttf, mode="ref")(state, x0, y0)):
        for g, w in zip(a, b):
            assert torch.equal(g, w)
    step = api.make_chunk_step("klms", ttf, **kw)
    got = step(state, x0[:, None], y0[:, None], torch.ones(B, 1))
    assert torch.equal(got[0].theta, api.make_chunk_step("klms", ttf)(
        state, x0[:, None], y0[:, None], torch.ones(B, 1))[0].theta)
    assert api.make_queue("klms", ttf, B, device="cpu",
                          input_dim=3).input_dim == D_IN
    st, _ = api.run_stream("klms", ttf, x0[:, None], y0[:, None],
                           input_dim=1, mu=0.3)
    st2, _ = api.run_stream("klms", ttf, x0[:, None], y0[:, None], mu=0.3)
    assert torch.equal(st.theta, st2.theta)
    with pytest.raises(ValueError, match="feature_map"):
        api.make_server("klms", input_dim=D_IN, device="cpu")
    # repro's rule: input_dim= alone serves a dictionary learner.
    qsrv = api.make_server("qklms", input_dim=D_IN, device="cpu")
    assert qsrv.queue.input_dim == D_IN and qsrv.feature_map is None
    qsrv.submit(1, np.ones(D_IN, np.float32), 1.0)
    qsrv.drain()
    assert int(qsrv.snapshot.state.size[1]) == 1


def test_feature_map_matches_repro():
    """The port's FeatureMap against repro's on the same numpy draw:
    featurize and weights at 1e-6; rff_map / orf_map return one, as
    repro's do, and every helper that takes a TrigFeatures takes it."""
    from repro.features import base as jbase
    from repro_torch.features import base as tbase
    from repro_torch.features.random import orf_map, rff_map

    jtf, ttf = _maps(3)
    jfm = jbase.trig_map("rff", jtf, deterministic=False)
    tfm = tbase.trig_map("rff", ttf, deterministic=False)
    x = np.random.default_rng(3).normal(size=(4, 6, D_IN)).astype(np.float32)
    _close(tfm.featurize(convert.tensor(x, device="cpu")),
           jfm.featurize(x), 1e-6)
    _close(tfm.weights, jfm.weights, 1e-6)
    _close(tbase.feature_weights(tfm), jbase.feature_weights(jfm), 1e-6)
    assert (tfm.family, tfm.deterministic, tfm.num_features, tfm.input_dim) \
        == (jfm.family, jfm.deterministic, jfm.num_features, jfm.input_dim)
    assert tbase.as_trig(tfm) is ttf and tfm.trig is ttf
    assert tbase.num_features(tfm) == D_FEAT and tbase.input_dim(tfm) == D_IN
    assert tbase.feature_dtype(tfm) == torch.float32
    assert torch.equal(tbase.featurize(tfm, convert.tensor(x, device="cpu")),
                       tbase.trig_features(ttf, convert.tensor(x, device="cpu")))
    moved = tfm.to("cpu")
    assert isinstance(moved, tbase.FeatureMap) and moved.family == "rff"
    for make, family in ((rff_map, "rff"), (orf_map, "orf")):
        fm = make(torch.Generator().manual_seed(0), D_IN, 32, 2.0,
                  device="cpu")
        assert isinstance(fm, tbase.FeatureMap)
        assert (fm.family, fm.deterministic) == (family, False)
        xt = convert.tensor(x, device="cpu")
        assert torch.equal(fm.featurize(xt), tbase.trig_features(fm.trig, xt))
        assert torch.equal(fm.weights, fm.trig.scale ** 2)


def test_feature_map_serves_like_trig_features():
    """A FeatureMap serves through make_server on the CPU bit for bit as
    its TrigFeatures does."""
    from repro_torch.features.base import trig_map

    _, ttf = _maps(4)
    fm = trig_map("rff", ttf, deterministic=False)
    a = api.make_server("klms", feature_map=fm, bank=B, chunk=4,
                        device="cpu")
    b = api.make_server("klms", feature_map=ttf, bank=B, chunk=4,
                        device="cpu")
    xs = _serve_same_stream(a, b, seed=8)
    assert torch.equal(a.snapshot.state.theta, b.snapshot.state.theta)
    xq = np.stack([xs[:5]] * B)
    assert torch.equal(a.predict_block(xq), b.predict_block(xq))
    assert torch.equal(a.predict(2, xs[:5]), b.predict(2, xs[:5]))


# repro's package-level names the port does not have yet, each with the
# ROADMAP §1 entry that ports it: none is left in these packages.
UNPORTED_NAMES = {
    "serve": {},
    "core": {},
    "features": {},
    "kernels": {},
    "obs": {},
    "launch": {},
    "roofline": {},
}


def _repro_modules() -> list:
    """Every module of repro (found without importing the modules)."""
    import pkgutil

    import repro

    return sorted(m.name for m in pkgutil.walk_packages(repro.__path__,
                                                         "repro."))


def _import_repro(name):
    """Import a repro module; repro.launch.dryrun sets XLA_FLAGS for 512
    host devices when imported, which is put back so that JAX in this
    process keeps its one device."""
    import importlib
    import os

    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _replaced_by_csrc(module: str, name: str) -> bool:
    """The Pallas entry points of repro/kernels/*.py (``*_pallas`` and the
    kernel bodies ``*_kernel``), which the CUDA sources under
    src/repro_torch/csrc/ replace."""
    return module.startswith("repro.kernels.") and name.endswith(
        ("_pallas", "_kernel"))


@pytest.mark.parametrize("package", sorted(UNPORTED_NAMES))
def test_package_exports_cover_repro(package):
    """Every name in repro's package __all__ is on the port's package, or
    in UNPORTED_NAMES with its ROADMAP entry (and then not on the port's
    package). The kernels' op names shadow their submodules there, as in
    repro."""
    import importlib

    jpkg = importlib.import_module(f"repro.{package}")
    tpkg = importlib.import_module(f"repro_torch.{package}")
    unported = UNPORTED_NAMES[package]
    assert set(unported) <= set(jpkg.__all__)
    missing = [n for n in jpkg.__all__
               if n not in unported and not hasattr(tpkg, n)]
    assert not missing, f"repro_torch.{package} lacks {missing}"
    assert not [n for n in unported if hasattr(tpkg, n)]
    assert all(n in tpkg.__all__ for n in jpkg.__all__ if n not in unported)
    if package == "kernels":
        from repro_torch.kernels import ops

        for name in ("rff_features", "rff_attention", "flash_attention"):
            assert getattr(tpkg, name) is getattr(ops, name)
    if package == "serve":
        from repro_torch.serve import reset_slots  # noqa: F401


@pytest.mark.parametrize("module", _repro_modules())
def test_module_exports_cover_repro(module):
    """Every name in a repro module's __all__ is in the port module of the
    same path, but the Pallas entry points that csrc/ replaces (which the
    port does not have)."""
    import importlib

    jmod = _import_repro(module)
    names = getattr(jmod, "__all__", None)
    if names is None:
        names = []
    tmod = importlib.import_module("repro_torch" + module[len("repro"):])
    replaced = [n for n in names if _replaced_by_csrc(module, n)]
    missing = [n for n in names if n not in replaced and not hasattr(tmod, n)]
    assert not missing, f"{tmod.__name__} lacks {missing}"
    assert not [n for n in replaced if hasattr(tmod, n)]
    if hasattr(tmod, "__all__"):
        assert all(n in tmod.__all__ for n in names if n not in replaced)


@pytest.mark.parametrize("learner,family", [
    *(("klms", f) for f in ("rff", "orf", "qmc", "gq", "taylor")),
    ("krls", "gq"), ("krls", "taylor"),
])
def test_feature_family_server_matches_repro(learner, family):
    """make_server with every feature family (taylor through the generic
    route of every tier): flushes, reads, a blocked readmit mid-stream and
    make_tick, against repro's server on the same map and stream."""
    from repro import features as JF

    jfm = JF.make_feature_map(family, D_IN, 40, 2.0,
                              key=jax.random.PRNGKey(0))
    tfm = convert.feature_map(family, [np.asarray(a) for a in jfm.params],
                              deterministic=jfm.deterministic, device="cpu")
    hp = dict(mu=0.5) if learner == "klms" else dict(lam=1e-2, beta=0.999)
    common = dict(bank=B, chunk=4, log_capacity=64, rebuild_mode="blocked",
                  **hp)
    jsrv = japi.make_server(learner, feature_map=jfm, mode="xla", **common)
    tsrv = api.make_server(learner, feature_map=tfm, device="cpu", **common)
    tenants, xs, ys = _stream(10, 160)
    for i in range(160):
        for srv in (jsrv, tsrv):
            srv.submit(int(tenants[i]), xs[i], ys[i])
            if i == 60:
                srv.evict(0)
                srv.evict(1)
            if i == 120:
                assert srv.readmit(0) > 0 and srv.readmit(1) > 0
        if i % 40 == 39:
            _flush_results_close(jsrv.flush(), tsrv.flush())
    _flush_results_close(jsrv.drain(), tsrv.drain())
    got, want = tsrv.snapshot.state, jsrv.snapshot.state
    _close(got.theta, want.theta)
    if learner == "krls":
        p, q = convert.to_numpy(got.pmat), np.asarray(want.pmat)
        assert np.all(np.abs(p - q).max((1, 2))
                      <= SLICE_TOL * np.abs(q).max((1, 2)))
    xq = np.random.default_rng(11).normal(size=(B, 5, D_IN)).astype(
        np.float32)
    _close(tsrv.predict_block(xq), jsrv.predict_block(xq))
    _close(tsrv.predict(3, xq[3]), jsrv.predict(3, xq[3]))
    tick = api.make_tick(learner, tfm, **hp)
    jtick = japi.make_tick(learner, jfm, mode="xla", **hp)
    x0, y0 = xq[:, 0], np.ones(B, np.float32)
    tnext, tout = tick(got, convert.tensor(x0, device="cpu"),
                       convert.tensor(y0, device="cpu"))
    jnext, jout = jtick(want, x0, y0)
    _close(tout.error, jout.error)
    _close(tnext.theta, jnext.theta)



def _leaves(obj) -> list:
    """The tensors of a shim's or a facade's result, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _leaves(obj[k])]
    if isinstance(obj, (float, int, np.floating)):  # a drained (pred, err)
        return [torch.tensor(float(obj), dtype=torch.float64)]
    return []


def _drive(srv, tenants, xs, ys):
    for t, x, y in zip(tenants, xs, ys):
        srv.submit(int(t), x, float(y))
    return srv.drain()


def _shim_and_facade(name: str) -> tuple:
    """Results of ``name`` and of the facade call it wraps on the same
    inputs (the CPU, repro's signature)."""
    from repro_torch.core.bank import klms_bank_init, krls_bank_init
    from repro_torch.serve import bank_loop, queue, snapshot

    _, ttf = _maps()
    mu, lam, beta, k = 0.4, 1e-2, 0.99, 4
    rng = np.random.default_rng(11)
    xs = torch.tensor(rng.normal(size=(B, 9, D_IN)), dtype=torch.float32)
    ys = torch.tensor(rng.normal(size=(B, 9)), dtype=torch.float32)
    mask = torch.tensor(rng.random((B, 9)) < 0.7, dtype=torch.float32)
    kstate = klms_bank_init(ttf, B)
    kstate = kstate._replace(theta=torch.tensor(
        rng.normal(size=(B, D_FEAT)), dtype=torch.float32))
    rstate = krls_bank_init(ttf, B, lam)
    tenants, sx, sy = _stream(12, 60)
    if name == "make_bank_server":
        return (bank_loop.make_bank_server(ttf, mu)(kstate, xs[:, 0], ys[:, 0]),
                api.make_tick("klms", ttf, mu=mu)(kstate, xs[:, 0], ys[:, 0]))
    if name == "make_krls_bank_server":
        return (bank_loop.make_krls_bank_server(ttf, beta)(
                    rstate, xs[:, 0], ys[:, 0]),
                api.make_tick("krls", ttf, beta=beta)(
                    rstate, xs[:, 0], ys[:, 0]))
    if name == "serve_bank_stream":
        return (bank_loop.serve_bank_stream(ttf, xs, ys, mu, chunk=k),
                api.run_stream("klms", ttf, xs, ys, chunk=k, mu=mu))
    if name == "serve_krls_bank_stream":
        return (bank_loop.serve_krls_bank_stream(ttf, xs, ys, lam, beta,
                                                 chunk=k),
                api.run_stream("krls", ttf, xs, ys, chunk=k, lam=lam,
                               beta=beta))
    if name == "reset_tenants":
        return (bank_loop.reset_tenants(kstate, [1, 3]),
                api.reset_slots(kstate, [1, 3], learner="klms"))
    if name == "reset_krls_tenants":
        state, _ = api.run_stream("krls", ttf, xs, ys, lam=lam, beta=beta)
        return (bank_loop.reset_krls_tenants(state, [0, 5], lam),
                api.reset_slots(state, [0, 5], learner="krls", lam=lam))
    if name == "make_chunked_bank_server":
        return (queue.make_chunked_bank_server(ttf, mu)(kstate, xs, ys, mask),
                api.make_chunk_step("klms", ttf, mu=mu)(kstate, xs, ys,
                                                        mask))
    if name == "make_chunked_krls_bank_server":
        return (queue.make_chunked_krls_bank_server(ttf, beta)(
                    rstate, xs, ys, mask),
                api.make_chunk_step("krls", ttf, beta=beta)(
                    rstate, xs, ys, mask))
    if name in ("klms_micro_batch_queue", "krls_micro_batch_queue"):
        learner = name[:4]
        hp = dict(mu=mu) if learner == "klms" else dict(lam=lam, beta=beta)
        shim = getattr(queue, name)(ttf, B, chunk=k, device="cpu", **hp)
        facade = api.make_queue(learner, ttf, B, chunk=k, device="cpu", **hp)
        return ((_drive(shim, tenants, sx, sy), shim.state),
                (_drive(facade, tenants, sx, sy), facade.state))
    learner = name[:4]
    hp = dict(mu=mu) if learner == "klms" else dict(lam=lam, beta=beta)
    shim = getattr(snapshot, name)(ttf, B, chunk=k, device="cpu",
                                   log_capacity=64, **hp)
    facade = api.make_server(learner, feature_map=ttf, bank=B, chunk=k,
                             device="cpu", log_capacity=64, **hp)
    results = []
    for srv in (shim, facade):
        drained = _drive(srv, tenants, sx, sy)
        srv.evict(0)
        _drive(srv, tenants[:9], sx[:9], sy[:9])
        srv.readmit(0)
        results.append((drained, srv.snapshot.state,
                        srv.predict_block(np.asarray(xs[:, :3]))))
    assert isinstance(shim, type(facade.snapshot_server))
    return tuple(results)


SHIM_NAMES = (
    "make_bank_server", "serve_bank_stream", "reset_tenants",
    "make_krls_bank_server", "serve_krls_bank_stream", "reset_krls_tenants",
    "make_chunked_bank_server", "make_chunked_krls_bank_server",
    "klms_micro_batch_queue", "krls_micro_batch_queue",
    "klms_snapshot_server", "krls_snapshot_server",
)


@pytest.mark.parametrize("name", SHIM_NAMES)
def test_deprecated_factory_warns_once_and_equals_its_facade(name):
    """Each of repro's twelve deprecated serve names: one
    DeprecationWarning per process (re-armed by
    ``api._reset_deprecation_state``), and its result bit for bit the
    facade call it wraps (a served stream, an evict and a readmit for the
    snapshot servers)."""
    import warnings

    import repro_torch.serve as tserve
    from repro.serve import __all__ as repro_serve

    assert name in repro_serve and name in tserve.__all__
    api._reset_deprecation_state()
    with pytest.warns(DeprecationWarning, match=name):
        shim, facade = _shim_and_facade(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _shim_and_facade(name)
    assert not [w for w in caught if name in str(w.message)]
    got, want = _leaves(shim), _leaves(facade)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
