"""The port's LM training half (``lm_loss``, the autograd wrapping of
kernels 10 and 11, ``make_train_step``, checkpoints, the trainer, elastic
re-placement and the launcher) held against ``repro`` on the CPU.

Parameters come from ``repro``'s ``init_params`` and are carried over by
``repro_torch.convert.lm_params``; inputs come from
``np.random.default_rng(seed)``. The port runs on the CPU
(``device="cpu"``), where every kernel is its plain PyTorch version;
``repro``'s jitted functions are cached per config.

Tolerances, each stated in its test:
* ``lm_loss`` at f32: the value at 1e-5 (relative), each leaf's gradient
  normwise at 1e-4 of the leaf's norm (another summation order in every
  product; a leaf whose gradient is zero in ``repro`` must be exactly zero);
* the autograd wrapping of kernels 10 and 11, with the kernel's forward
  swapped for its plain version: plain autograd's gradients bit for bit;
* each of three train steps from ``repro``'s state before it, against
  ``repro``'s state after it: the loss and grad_norm metrics at 1e-5
  (relative); params at 1e-5 where ``|g_ref| > 1e-6 max|g_ref|`` in the
  leaf (``g_ref``: ``repro``'s full-batch gradient at that step's params),
  the rest within 2 lr. AdamW's first step is about ``lr * sign(g)``, and
  the sign of a gradient at rounding level can differ between frameworks;
* checkpoints: every leaf exact; the trainer's resume: bit for bit.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro.optim import schedules as jsched
from repro.train import checkpoint as jckpt
from repro.train.steps import init_train_state as jax_init_train_state
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.lm_data import batch_at_step
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import lm_loss
from repro_torch.optim import AdamWState, schedules
from repro_torch.optim.tree import leaves, tree_map, unflatten
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.elastic import remesh
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

LOSS_REL, GRAD_REL, PARAM_ABS, SIGN_FLOOR = 1e-5, 1e-4, 1e-5, 1e-6


def _np(t):
    return t.detach().float().numpy()


def _reduced(arch, get):
    """The arch's reduced config (the hybrid with two extra recurrent
    blocks after its group, as tests/test_torch_lm.py takes it)."""
    cfg = get(arch).reduced()
    if cfg.mixer == "rglru_hybrid":
        cfg = replace(cfg, num_layers=5)
    return cfg


# (case, arch, change): every arch reduced; qwen2 with RFF attention, with
# the streamed vocab (4 chunks) and with 3 heads padded to 4.
CASES = [(arch, arch, {}) for arch in ARCH_IDS] + [
    ("qwen2-rff", "qwen2-0.5b", dict(attention="rff")),
    ("qwen2-vocab-chunks", "qwen2-0.5b", dict(loss_vocab_chunks=4)),
    ("llama3-padded-heads", "llama3-8b",
     dict(num_heads=3, num_kv_heads=1, pad_heads_to=4)),
]


@functools.lru_cache(maxsize=None)
def _model(case):
    """(repro cfg, repro params, port cfg, port params)."""
    _, arch, change = next(c for c in CASES if c[0] == case)
    jcfg = replace(_reduced(arch, jax_get_config), **change)
    cfg = replace(_reduced(arch, get_config), **change)
    params = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return jcfg, params, cfg, tparams


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
    def loss(p, tokens, embeds, labels):
        return jt.lm_loss(p, jcfg, tokens=tokens, embeds=embeds,
                          labels=labels)

    return jax.jit(jax.value_and_grad(loss))


def _inputs(cfg, seed, batch=2, seq=32):
    """Tokens, or for the frontend archs embeds and labels with -1 on a
    few positions."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
                .astype(np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels[rng.random((batch, seq)) < 0.2] = -1
    return {"embeds": (rng.normal(size=(batch, seq, cfg.d_model))
                       * cfg.d_model ** -0.5).astype(np.float32),
            "labels": labels}


def _port_inputs(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _grads(tparams, cfg, inp, **kw):
    """The port's (loss, grads) of lm_loss by plain autograd."""
    live = tree_map(lambda p: p.detach().requires_grad_(), tparams)
    loss = lm_loss(live, cfg, **_port_inputs(inp), **kw)
    flat = leaves(live)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, got)]


def _normwise(got, want, rel, what):
    want_norm = float(np.linalg.norm(want))
    err = float(np.linalg.norm(got - want))
    if want_norm == 0.0:
        assert err == 0.0, f"{what}: repro's gradient is zero, ours {err:.3g}"
    else:
        assert err <= rel * want_norm, (
            f"{what}: |got - want| {err:.3g} > {rel} * |want| {want_norm:.3g}")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_lm_loss_value_and_grads_match_repro(case):
    jcfg, params, cfg, tparams = _model(case)
    inp = _inputs(cfg, 0)
    jinp = {k: jnp.asarray(inp.get(k)) if k in inp else None
            for k in ("tokens", "embeds", "labels")}
    want, jgrads = _jax_value_and_grad(jcfg)(params, **jinp)
    loss, got = _grads(tparams, cfg, inp)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(loss.item() - float(want)) <= LOSS_REL * abs(float(want))
    want_leaves = leaves(convert.lm_params(jax.tree.map(np.asarray, jgrads),
                                           cfg, device="cpu"))
    assert len(got) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        assert g.shape == w.shape and g.dtype == w.dtype
        _normwise(_np(g), _np(w), GRAD_REL, f"{case} leaf {i} {tuple(g.shape)}")
    if case == "llama3-padded-heads":
        for block in _grads_tree(tparams, got)["blocks"]:
            wo = block["attn"]["wo"]["w"]
            assert float(wo[3:].abs().max()) == 0.0
            assert float(wo[:3].abs().max()) > 0.0


def _grads_tree(like, flat):
    return unflatten(like, flat)


def test_lm_loss_streamed_route_equals_plain_route():
    """The streamed vocab route against the plain route on the same model:
    the same loss at 1e-6 (another order of the f32 sums); a chunk count
    that does not divide the vocab takes the plain route, bit for bit."""
    _, _, cfg, tparams = _model("qwen2-0.5b")
    tokens = torch.from_numpy(_inputs(cfg, 1)["tokens"])
    plain = lm_loss(tparams, cfg, tokens=tokens)
    chunked = lm_loss(tparams, replace(cfg, loss_vocab_chunks=8),
                      tokens=tokens)
    assert abs(float(chunked) - float(plain)) <= 1e-6 * float(plain)
    ragged = lm_loss(tparams, replace(cfg, loss_vocab_chunks=3),
                     tokens=tokens)
    assert torch.equal(ragged, plain)


# ---------------------------------------------------------------------------
# Kernels 10 and 11 under autograd
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_kernels(monkeypatch):
    """The CUDA forwards of kernels 10 and 11 swapped for their plain
    versions, counting calls as the wrappers count launches."""
    calls = {"flash": 0, "rff": 0}

    def flash(q, k, v, *, causal=True):
        calls["flash"] += 1
        return ref.flash_attention_ref(q, k, v, causal=causal)

    def rff(phi_q, phi_k, v, *, chunk=256, normalize=True, eps=1e-6):
        calls["rff"] += 1
        return ref.chunked_linear_attention_ref(phi_q, phi_k, v, chunk=chunk,
                                                normalize=normalize, eps=eps)

    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ops, "rff_attention_cuda", rff)
    return calls


def _attention_inputs(op, seed):
    rng = np.random.default_rng(seed)
    if op == "flash":
        shapes = [(3, 32, 16), (3, 32, 16), (3, 32, 24)]
    else:
        shapes = [(3, 32, 20), (3, 32, 20), (3, 32, 12)]
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if op == "rff":  # positive features
        xs[0], xs[1] = np.abs(xs[0]) + 0.1, np.abs(xs[1]) + 0.1
    return [torch.from_numpy(x) for x in xs]


def _call(op, mode, q, k, v):
    if op == "flash":
        return ops.flash_attention(q, k, v, mode=mode)
    return ops.rff_attention(q, k, v, mode=mode, chunk=8)


@pytest.mark.parametrize("need", [(True, True, True), (False, True, False)])
@pytest.mark.parametrize("op", ["flash", "rff"])
def test_kernel_with_plain_grad_is_plain_autograd_bitwise(plain_kernels, op,
                                                          need):
    """mode="cuda" under autograd goes through the Function: its forward
    is the (here plain) kernel, launched once a call and never in the
    backward; its gradients equal plain autograd's bit for bit, None where
    an input needs none."""
    base = _attention_inputs(op, 4)
    g_out = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 32, base[2].shape[-1])).astype(np.float32))
    ours = [x.clone().requires_grad_(n) for x, n in zip(base, need)]
    plain = [x.clone().requires_grad_(n) for x, n in zip(base, need)]
    out = _call(op, "cuda", *ours)
    assert out.grad_fn is not None and plain_kernels[op] == 1
    want = _call(op, "ref", *plain)
    assert torch.equal(out, want)
    got = torch.autograd.grad(out, [x for x in ours if x.requires_grad],
                              g_out)
    wanted = torch.autograd.grad(want, [x for x in plain if x.requires_grad],
                                 g_out)
    assert plain_kernels[op] == 1
    for a, b in zip(got, wanted):
        assert torch.equal(a, b)
    with torch.no_grad():  # no grad: the wrapper alone
        assert _call(op, "cuda", *ours).grad_fn is None
    assert plain_kernels[op] == 2


def test_rff_model_grads_through_the_function_are_plain_bitwise(
        plain_kernels):
    """lm_loss of the RFF qwen2 with kernel_mode="cuda" (kernel 10 once a
    layer, through the Function) gives kernel_mode="ref"'s loss and
    gradients bit for bit."""
    _, _, cfg, tparams = _model("qwen2-rff")
    inp = _inputs(cfg, 2)
    loss_k, g_k = _grads(tparams, cfg, inp, kernel_mode="cuda")
    assert plain_kernels["rff"] == cfg.num_layers
    loss_p, g_p = _grads(tparams, cfg, inp, kernel_mode="ref")
    assert torch.equal(loss_k, loss_p)
    for a, b in zip(g_k, g_p):
        assert torch.equal(a, b)
    assert plain_kernels["rff"] == cfg.num_layers


@pytest.mark.parametrize("op", ["flash", "rff"])
def test_cuda_mode_on_cpu_tensors_raises(op):
    """No fallback: mode="cuda" on CPU tensors raises, with or without
    autograd."""
    xs = _attention_inputs(op, 6)
    with pytest.raises(ValueError, match="CUDA"):
        _call(op, "cuda", *xs)
    with pytest.raises(ValueError, match="CUDA"):
        _call(op, "cuda", *(x.requires_grad_() for x in xs))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

TRAIN_CASES = {"qwen2-gqa": ("qwen2-0.5b", {}),
               "qwen2-rff": ("qwen2-0.5b", dict(attention="rff")),
               "deepseek": ("deepseek-v2-lite-16b", {})}
STEPS, MICRO, LR = 3, 2, dict(peak_lr=1e-3, warmup_steps=1, total_steps=3)


@functools.lru_cache(maxsize=None)
def _train_run(case):
    """repro's three steps from init_train_state(PRNGKey(4)) on batches of
    (4, 16) tokens: its state before and after each step (numpy), its
    metrics, and its full-batch gradient at each step's params."""
    arch, change = TRAIN_CASES[case]
    jcfg = replace(jax_get_config(arch).reduced(), **change)
    cfg = replace(get_config(arch).reduced(), **change)
    state = jax_init_train_state(jax.random.PRNGKey(4), jcfg)
    step = jax.jit(jax_make_train_step(
        jcfg, num_microbatches=MICRO,
        lr_schedule=functools.partial(jsched.warmup_cosine, **LR)))
    grad = jax.jit(jax.grad(lambda p, t: jt.lm_loss(p, jcfg, tokens=t)))
    batches = [_inputs(cfg, 10 + i, batch=4, seq=16) for i in range(STEPS)]
    states, metrics, g_ref = [jax.tree.map(np.asarray, state)], [], []
    for b in batches:
        g_ref.append(jax.tree.map(np.asarray, grad(
            state["params"], jnp.asarray(b["tokens"]))))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    return cfg, batches, states, metrics, g_ref


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_matches_repro(case):
    """Each of three steps from repro's state before it (two microbatches,
    warmup_cosine) against repro's state after it, under the sign rule."""
    cfg, batches, states, metrics, g_ref = _train_run(case)
    step = make_train_step(cfg, num_microbatches=MICRO,
                           lr_schedule=functools.partial(
                               schedules.warmup_cosine, **LR))
    for i, (b, want) in enumerate(zip(batches, metrics)):
        state, got = step(convert.train_state(states[i], cfg, device="cpu"),
                          _port_inputs(b))
        assert set(got) == {"loss", "grad_norm", "lr"}
        for k in ("loss", "grad_norm"):
            assert got[k].ndim == 0
            assert abs(float(got[k]) - want[k]) <= LOSS_REL * abs(want[k]), k
        assert float(got["lr"]) == want["lr"]
        assert int(state["step"]) == int(state["opt"].count) == i + 1
        after = convert.train_state(states[i + 1], cfg, device="cpu")
        sign = leaves(convert.lm_params(g_ref[i], cfg, device="cpu"))
        for j, (g, w, s) in enumerate(zip(leaves(state["params"]),
                                          leaves(after["params"]), sign)):
            diff, s = np.abs(_np(g) - _np(w)), np.abs(_np(s))
            live = s > SIGN_FLOOR * s.max()
            what = f"{case} step {i} leaf {j} {tuple(g.shape)}"
            assert diff[live].max(initial=0.0) <= PARAM_ABS, what
            assert diff[~live].max(initial=0.0) <= 2 * want["lr"], what


def test_train_step_keeps_rff_buffers_out_of_the_gradient():
    """The RFF feature buffers get zero gradients but stay AdamW leaves:
    omega (D rows, two dims) decays by lr * weight_decay exactly as
    repro's update computes it; bias and scale (vectors) do not move."""
    cfg = replace(get_config("qwen2-0.5b").reduced(), attention="rff")
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.from_numpy(_inputs(cfg, 3, batch=2, seq=16)["tokens"])
    new, metrics = make_train_step(cfg, peak_lr=1e-2)(state,
                                                      {"tokens": tokens})
    for old, got in zip(state["params"]["blocks"], new["params"]["blocks"]):
        p = old["attn"]["omega"]
        want = p - torch.tensor(1e-2) * (torch.zeros_like(p) + 0.1 * p)
        assert torch.equal(got["attn"]["omega"], want)
        for k in ("bias", "scale"):
            assert torch.equal(got["attn"][k], old["attn"][k])
    assert float(metrics["loss"]) > 0


def test_train_step_rejects_ragged_microbatches():
    cfg = get_config("qwen2-0.5b").reduced()
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, num_microbatches=2)(
            state, {"tokens": torch.zeros(3, 8, dtype=torch.int32)})


def test_init_train_state_layout():
    cfg = get_config("arctic-480b").reduced()
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert isinstance(state["opt"], AdamWState)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert all(m.dtype == torch.bfloat16 for m in leaves(state["opt"].m))
    jstate = jax.eval_shape(lambda: jax_init_train_state(
        jax.random.PRNGKey(0), jax_get_config("arctic-480b").reduced()))
    want = [tuple(a.shape) for a in jax.tree.leaves(jstate["params"])]
    got = jax.tree.leaves(convert.train_state_to_numpy(state, cfg)["params"])
    assert [a.shape for a in got] == want


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_keeps_every_leaf(tmp_path):
    state = {"a": torch.arange(10.0),
             "b": {"c": torch.randn(3, 3).to(torch.bfloat16)},
             "opt": AdamWState(m=[torch.ones(2)], v=[torch.zeros(2)],
                               count=torch.tensor(7, dtype=torch.int32)),
             "step": torch.tensor(5, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 5, state)
    assert path.endswith("step_5.ckpt")
    assert (tmp_path / "LATEST").read_text() == "5"
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("tmp.")]
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 5 and isinstance(restored["opt"], AdamWState)
    for a, b in zip(leaves(restored), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_gc(tmp_path):
    for s in range(1, 8):
        ckpt.save(str(tmp_path), s, {"x": torch.zeros(2)}, keep=3)
    assert ckpt.list_steps(str(tmp_path)) == [5, 6, 7]
    assert ckpt.latest_step(str(tmp_path)) == 7


@pytest.mark.parametrize("fault", ["corrupt_newest", "torn_latest",
                                   "latest_missing_file", "no_latest"])
def test_restore_falls_back_to_newest_readable(tmp_path, fault):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.ones(4)})
    ckpt.save(d, 2, {"x": 2 * torch.ones(4)})
    want = 2
    if fault == "corrupt_newest":
        (tmp_path / "step_2.ckpt").write_bytes(b"garbage")
        want = 1
    elif fault == "torn_latest":
        (tmp_path / "LATEST").write_text("2x")
    elif fault == "latest_missing_file":
        (tmp_path / "LATEST").write_text("9")
    else:
        (tmp_path / "LATEST").unlink()
    restored, step = ckpt.restore(d, device="cpu")
    assert step == want
    assert torch.equal(restored["x"], want * torch.ones(4))


def test_restore_refuses_other_globals(tmp_path):
    """A payload naming anything but numpy, builtins and AdamWState is
    unreadable, so restore falls back past it."""
    import pickle

    ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    with open(tmp_path / "step_2.ckpt", "wb") as f:
        pickle.dump({"step": 2, "state": {"x": functools.partial(print)}}, f)
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 1
    assert ckpt.restore(str(tmp_path / "empty"), device="cpu") is None


def test_repro_checkpoint_restores_into_the_port(tmp_path):
    """repro's training checkpoint (its AdamWState pickled by name) restores
    into the port's layout with every leaf exact, and the port's state goes
    back to repro's layout leaf for leaf. At bf16 (ml_dtypes leaves) both
    ways: repro's checkpoint restores into the port bit for bit, and the
    port's checkpoint restores into repro with ml_dtypes bf16 leaves."""
    jcfg = jax_get_config("deepseek-v2-lite-16b").reduced()
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    jstate = jax_init_train_state(jax.random.PRNGKey(6), jcfg)
    jstate = dict(jstate, step=jnp.asarray(3, jnp.int32))
    jckpt.save(str(tmp_path), 3, jstate)
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 3 and type(restored["opt"]) is AdamWState
    state = convert.train_state(restored, cfg, device="cpu")
    back = convert.train_state_to_numpy(state, cfg)
    got, want = jax.tree.leaves(back), jax.tree.leaves(
        jax.tree.map(np.asarray, jstate))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    bf16 = np.dtype(jnp.bfloat16)
    jstate = jax_init_train_state(jax.random.PRNGKey(7),
                                  replace(jcfg, dtype="bfloat16"))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    assert {a.dtype for a in want} >= {bf16, np.dtype(np.float32)}

    def bits(a):
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.int16) if a.dtype == torch.bfloat16
                 else a).numpy()
        return a.view(np.int16) if a.dtype == bf16 else a

    jckpt.save(str(tmp_path / "bf16"), 4, jstate)
    restored, step = ckpt.restore(str(tmp_path / "bf16"), device="cpu")
    got = jax.tree.leaves(restored)
    assert step == 4 and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == (torch.bfloat16 if b.dtype == bf16 else
                           torch.from_numpy(b).dtype)
        np.testing.assert_array_equal(bits(a), bits(b))
    ckpt.save(str(tmp_path / "back"), 5, restored)
    back, step = jckpt.restore(str(tmp_path / "back"))
    got = jax.tree.leaves(back)
    assert step == 5 and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# Trainer, elastic, launcher
# ---------------------------------------------------------------------------


def _batch_fn(cfg):
    def fn(step):
        return {"tokens": batch_at_step(0, step, global_batch=4, seq_len=16,
                                        vocab=cfg.vocab_size, device="cpu")}

    return fn


def _trainer(cfg, total, ckpt_dir, **kw):
    return Trainer(cfg, TrainerConfig(total_steps=total, ckpt_every=100,
                                      ckpt_dir=str(ckpt_dir),
                                      num_microbatches=2, log_every=100),
                   _batch_fn(cfg), device="cpu", **kw)


@pytest.fixture
def deterministic():
    """CPU's index_put with accumulate (the embedding's backward) is
    deterministic only under torch.use_deterministic_algorithms."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_trainer_resume_bit_exact(tmp_path, deterministic):
    """4 steps straight == 2 steps, a new Trainer, a resume and 2 more."""
    cfg = get_config("qwen2-0.5b").reduced()
    ta = _trainer(cfg, 4, tmp_path / "a")
    ta.run()
    _trainer(cfg, 2, tmp_path / "b").run()
    tb = _trainer(cfg, 4, tmp_path / "b")
    assert tb.init_or_resume() == 2
    tb.run()
    assert len(tb.step_times) == 2
    for a, b in zip(leaves(ta.state), leaves(tb.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ckpt.list_steps(str(tmp_path / "b")) == [2, 4]


class _Clock:
    """A fake ``time`` module: each reading advances 5 ms; sleep advances
    by its argument."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 0.005
        return self.now

    def sleep(self, s):
        self.now += s


def test_straggler_watchdog_counts_slow_steps(tmp_path, monkeypatch):
    """On a fake clock: one step 80x the median is counted, once; the
    first 7 steps are never judged."""
    monkeypatch.setattr(trainer_mod, "time", _Clock())
    cfg = get_config("qwen2-0.5b").reduced()
    t = _trainer(cfg, 14, tmp_path,
                 delay_injector=lambda step: 0.4 if step in (3, 12) else 0.0)
    t.run()
    assert t.straggler_events == 1
    assert len(t.step_times) == 14


def test_remesh_preserves_values(tmp_path):
    """Onto devices (a prefix placement and a full tree) and onto a
    one-rank gloo mesh as DTensors, and back: the values equal."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    state = {"w": torch.randn(8, 8), "opt": AdamWState(
        m=[torch.randn(8)], v=[torch.randn(8)],
        count=torch.tensor(2, dtype=torch.int32))}
    moved = remesh(state, torch.device("cpu"))
    assert type(moved["opt"]) is AdamWState
    for a, b in zip(leaves(moved), leaves(state)):
        assert torch.equal(a, b)
    cpu = torch.device("cpu")
    moved = remesh(state, {"w": cpu, "opt": AdamWState(m=[cpu], v=[cpu],
                                                       count=cpu)})
    assert torch.equal(moved["w"], state["w"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        placed = remesh(state, {"w": (mesh, [Shard(0)]),
                                "opt": (mesh, [Replicate()])})
        assert isinstance(placed["w"], DTensor)
        back = remesh(placed, cpu)
        for a, b in zip(leaves(back), leaves(state)):
            assert not isinstance(a, DTensor) and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_launch_train_runs_on_cpu_and_resumes(tmp_path, capsys):
    """Two reduced steps with --device cpu, checkpointed each step; the
    same command again resumes at step 2 and runs nothing; one more step
    resumes and runs one."""
    argv = ["--arch", "qwen2-0.5b", "--steps", "2", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    metrics = launch_train.main(argv)
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    assert np.isfinite(metrics["loss"])
    assert ckpt.list_steps(str(tmp_path)) == [1, 2]
    assert launch_train.main(argv) == {}
    argv[argv.index("--steps") + 1] = "3"
    assert set(launch_train.main(argv)) == {"loss", "grad_norm", "lr"}
    assert ckpt.list_steps(str(tmp_path)) == [1, 2, 3]


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), _batch_fn(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.train_state({"params": {}, "opt": (None, None, 0),
                             "step": 0}, cfg)
