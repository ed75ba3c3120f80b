"""The port's optimizers, schedules, gradient compression and LM data
stream held against ``repro`` on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go to both packages
as the same numbers. Tolerances, each stated in its test:
* AdamW, SGD, ``global_norm`` and the schedules on identical inputs: 1e-7
  of max|want| (f32 arithmetic in the same order; XLA's and PyTorch's
  ``pow``, ``sqrt`` and ``cos`` may round one ulp apart, and the sums of
  squares are taken in another order); bf16 leaves within one bf16 ulp
  (2^-8 of max|want|), since a one-ulp f32 difference can cross a bf16
  rounding boundary;
* the int8 compression's codes and scales: equal (the same f32 division
  and round half to even);
* the Markov token stream from ``repro``'s draws: equal, at vocab 151936
  (where ``repro``'s int32 products wrap) and at a reduced vocab.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_data as jdata
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.data import lm_data
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    schedules,
    sgd_update,
)
from repro_torch.optim import compression
from repro_torch.optim.tree import leaves, tree_map

F32, BF16_ULP = 1e-7, 2.0 ** -8


def close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rel * scale + 1e-30, (
        f"{what}: max|got - want| {err:.3g} > {rel} * max|want| {scale:.3g}")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(jnp.asarray(t, jnp.float32)))


def _tree(rng, scale=1.0):
    """A tree whose insertion order is not JAX's sorted order, with a
    matrix (decayed) and vectors (not decayed)."""
    return {"z": {"w": scale * rng.normal(size=(6, 5)).astype(np.float32)},
            "a": [rng.normal(size=(7,)).astype(np.float32),
                  {"b": rng.normal(size=(3, 4, 2)).astype(np.float32)}],
            "m": rng.normal(size=(5,)).astype(np.float32)}


def _torch_tree(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _check_tree(got, want, rel, what):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == getattr(torch, str(w.dtype)), (what, g.dtype,
                                                         w.dtype)
        close(_np(g), _np(w), rel, f"{what} leaf {i}")


def test_tree_order_is_jax_order():
    tree = _tree(np.random.default_rng(0))
    got = [a.shape for a in leaves(tree)]
    want = [a.shape for a in jax.tree.leaves(tree)]
    assert got == want


@pytest.mark.parametrize("param_dtype,moment", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_matches_repro(param_dtype, moment, grad_clip):
    """Three updates on identical gradients (large enough that the clip
    acts at grad_clip = 1), lr a 0-d f32 from the schedule: params and
    moments at 1e-7 of max|want| in f32, within one bf16 ulp in bf16
    leaves; the count exactly."""
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    pdt, mdt = getattr(torch, param_dtype), getattr(torch, moment)
    jpdt, jmdt = jnp.dtype(param_dtype), jnp.dtype(moment)
    tp, jp = _torch_tree(p_np, pdt), _jax_tree(p_np, jpdt)
    topt, jstate = adamw_init(tp, moment), jopt.adamw_init(jp, jmdt)
    assert isinstance(topt, AdamWState) and topt.count.dtype == torch.int32
    rel = F32 if param_dtype == moment == "float32" else BF16_ULP
    for i in range(3):
        g_np = _tree(rng, scale=3.0)
        lr = np.float32(1e-2 * (i + 1))
        tp, topt = adamw_update(tp, _torch_tree(g_np, pdt), topt,
                                torch.tensor(lr), grad_clip=grad_clip)
        jp, jstate = jopt.adamw_update(jp, _jax_tree(g_np, jpdt), jstate,
                                       jnp.asarray(lr), grad_clip=grad_clip)
        _check_tree(tp, jp, rel, f"params step {i}")
        _check_tree(topt.m, jstate.m, rel, f"m step {i}")
        _check_tree(topt.v, jstate.v, rel, f"v step {i}")
        assert int(topt.count) == int(jstate.count) == i + 1


def test_global_norm_and_sgd_match_repro():
    """global_norm at 1e-7 (relative), the leaves summed in JAX's order;
    sgd_update at 1e-7 of max|want|."""
    rng = np.random.default_rng(2)
    p_np, g_np = _tree(rng), _tree(rng, scale=2.0)
    got = global_norm(_torch_tree(g_np))
    want = jopt.global_norm(_jax_tree(g_np))
    assert got.dtype == torch.float32 and got.ndim == 0
    close(float(got), float(want), F32, "global_norm")
    _check_tree(sgd_update(_torch_tree(p_np), _torch_tree(g_np), 0.05),
                jopt.sgd_update(_jax_tree(p_np), _jax_tree(g_np), 0.05),
                F32, "sgd")


def test_schedules_match_repro():
    """warmup_cosine and constant over steps 0-1200 (past total_steps), at
    1e-7 of max|want|, as f32 0-d tensors."""
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
    got = np.array([float(schedules.warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw))
                    for s in range(0, 1201, 7)])
    want = np.asarray(jax.vmap(lambda s: jsched.warmup_cosine(s, **kw))(
        jnp.arange(0, 1201, 7, dtype=jnp.int32)))
    close(got, want, F32, "warmup_cosine")
    one = schedules.warmup_cosine(5, **kw)
    assert one.dtype == torch.float32 and one.ndim == 0
    c = schedules.constant(torch.tensor(3, dtype=torch.int32), lr=0.125)
    assert c.dtype == torch.float32 and float(c) == float(
        jsched.constant(jnp.int32(3), lr=0.125))


def test_compression_codes_and_scales_equal_repro():
    """Five rounds of error feedback on the same gradients: int8 codes and
    scales equal to repro's, residuals at 1e-7 of max|want|."""
    rng = np.random.default_rng(3)
    g_np = _tree(rng)
    g_np["tiny"] = np.zeros(4, np.float32)  # the 1e-12 floor
    tst = compression.init_state(_torch_tree(g_np))
    jst = jcomp.init_state(_jax_tree(g_np))
    for r in range(5):
        g_np = tree_map(lambda a: a + np.float32(0.01 * r), g_np)
        tq, ts, tst = compression.compress_tree(_torch_tree(g_np), tst)
        jq, js, jst = jcomp.compress_tree(_jax_tree(g_np), jst)
        for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(ts), jax.tree.leaves(js)):
            assert float(a) == float(b)
        _check_tree(tst.residual, jst.residual, F32, f"residual {r}")
        _check_tree(compression.decompress_tree(tq, ts),
                    jcomp.decompress_tree(jq, js), F32, f"decompress {r}")


# repro's tests/test_data_optim.py and test_fault_tolerance.py cases,
# mirrored on the port.

def test_adamw_minimizes_quadratic():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=10).astype(np.float32))
    params, target = {"w": w}, torch.ones(10)
    opt = adamw_init(params)
    for _ in range(400):
        params, opt = adamw_update(params, {"w": params["w"] - target}, opt,
                                   lr=0.05, weight_decay=0.0)
    assert float(0.5 * torch.sum((params["w"] - target) ** 2)) < 1e-3


def test_adamw_weight_decay_shrinks_weights():
    params = {"w": 5.0 * torch.ones(4, 4), "b": 5.0 * torch.ones(4)}
    zeros = tree_map(torch.zeros_like, params)
    p2, _ = adamw_update(params, zeros, adamw_init(params), lr=0.1,
                         weight_decay=0.5)
    assert float(p2["w"].abs().max()) < 5.0
    assert bool((p2["b"] == 5.0).all())  # vectors are not decayed


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(8)}
    big = {"w": 1e6 * torch.ones(8)}
    assert float(global_norm(big)) > 1e6
    p2, _ = adamw_update(params, big, adamw_init(params), lr=0.1,
                         grad_clip=1.0)
    assert bool(torch.isfinite(p2["w"]).all())


def test_warmup_cosine_shape():
    lrs = torch.stack([schedules.warmup_cosine(s, peak_lr=1.0,
                                               warmup_steps=100,
                                               total_steps=1000)
                       for s in range(1000)])
    assert float(lrs[0]) < 0.02
    assert abs(float(lrs[100]) - 1.0) < 0.02
    assert float(lrs[-1]) < 0.2
    assert float(lrs.max()) <= 1.0 + 1e-6


def test_gradient_compression_error_feedback():
    grads = {"w": torch.linspace(-1, 1, 1000)}
    st = compression.init_state(grads)
    total = torch.zeros(1000)
    for _ in range(50):
        q, s, st = compression.compress_tree(grads, st)
        total = total + compression.decompress_tree(q, s)["w"]
    assert float((total / 50 - grads["w"]).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# The LM token stream
# ---------------------------------------------------------------------------


def _repro_draws(key, batch, seq_len, vocab):
    """repro's markov_batch draws, split as it splits them."""
    k1, k2, k3 = jax.random.split(key, 3)
    start = jax.random.randint(k1, (batch,), 0, vocab)
    flips = jax.random.bernoulli(k2, 0.1, (batch, seq_len))
    jumps = jax.random.randint(k3, (batch, seq_len), 0, vocab)
    return [np.asarray(a) for a in (start, flips, jumps)]


@pytest.mark.parametrize("vocab", [151936, 256, 1])
def test_markov_from_noise_equals_repro(vocab):
    """repro's tokens, bit for bit, from repro's draws; at 151936 the
    int32 products wrap (e.g. token 150000 -> 93673, not the exact
    63081)."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = np.asarray(jdata.markov_batch(key, 4, 300, vocab))
    got = lm_data.markov_batch_from_noise(*_repro_draws(key, 4, 300, vocab),
                                          vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if vocab == 151936:
        one = lm_data.markov_batch_from_noise(
            np.array([150000]), np.zeros((1, 1), bool), np.zeros((1, 1)),
            vocab)
        assert int(one[0, 0]) == 93673


def test_batch_at_step_is_stateless():
    kw = dict(global_batch=3, seq_len=40, vocab=151936, device="cpu")
    a = lm_data.batch_at_step(5, 11, **kw)
    assert a.shape == (3, 40) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 151936
    lm_data.batch_at_step(5, 12, **kw)  # other draws between
    torch.randint(0, 10, (100,))
    np.testing.assert_array_equal(lm_data.batch_at_step(5, 11, **kw).numpy(),
                                  a.numpy())
    assert not torch.equal(lm_data.batch_at_step(5, 12, **kw), a)
    assert not torch.equal(lm_data.batch_at_step(6, 11, **kw), a)
    # The chain: off the jumps, each token follows from the one before
    # (int32 arithmetic, wrapping as repro's does).
    mult = 6364136223846793005 % 151936
    nxt = torch.remainder(a[:, :-1] * mult + 12345, 151936)
    follows = (a[:, 1:] == nxt).float().mean()
    assert 0.8 < float(follows) < 0.97


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_data.batch_at_step(0, 0, global_batch=1, seq_len=4, vocab=8)
