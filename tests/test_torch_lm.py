"""The port's LM serving slice (RFF linear attention, flash attention, the
decoder of all ten archs, the serving loop) held against ``repro`` on the
CPU.

Inputs come from ``np.random.default_rng(seed)``; model parameters come
from ``repro``'s ``init_params`` and are carried over by
``repro_torch.convert.lm_params``. The port runs on the CPU
(``device="cpu"``), where every kernel is its plain PyTorch version;
``repro`` runs its Pallas kernels 9-11 in interpret mode and its XLA
paths.

Tolerances (``repro``'s own):
* f32 RFF linear attention: 2e-5 of max|want|
  (tests/test_kernels_pallas.py::test_rff_attention_kernel_sweep);
* other f32 comparisons (decode block, flash attention, the model's
  logits, the prefill/decode state contract): 1e-5 of max|want|
  (tests/test_decode.py uses 1e-5);
* bf16 decode features: 2e-2 of max|want| (the read contract of
  tests/test_read_path.py): an f32 difference that moves a feature across
  a bf16 rounding boundary changes it by one bf16 ulp.

Not asserted here: a decode block equal to per-token decode bit for bit on
the CPU. ``repro`` itself fails that claim on this CPU
(tests/test_decode.py, tests/test_models.py; ROADMAP §3); the port's
block and per-token results are held to each other at 1e-5 instead, and
the card checks its kernel's bitwise contract (chip_smoke.py).
"""
import functools
import os
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rff_attention import (
    rff_attention_decode_block_pallas,
    rff_attention_pallas,
)
from repro.models import rff_attention as jrff
from repro.models import transformer as jt
from repro.serve import generate as jax_generate
from repro.train.steps import make_prefill_step as jax_make_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.rff import positive_random_features, sample_prf
from repro_torch.core.rff import RFF
from repro_torch.kernels import chunking, ops, ref
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.models import rff_attention as trff
from repro_torch.models import transformer
from repro_torch.models.frontend import stub_embeddings
from repro_torch.serve.serve_loop import generate, path_logits
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
F32, RFF_F32, BF16 = 1e-5, 2e-5, 2e-2


def close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rel * scale + 1e-30, (
        f"{what}: max|got - want| {err:.3g} > {rel} * max|want| {scale:.3g}")


def f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Ops: the port's plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


def _decode_inputs(rng, bh, tlen, dh, dfeat, dv, kind):
    w = f32(rng, dh, dfeat)
    if kind == "trig":
        b = rng.uniform(0, 2 * np.pi, dfeat).astype(np.float32)
        s = np.full(dfeat, np.sqrt(2.0 / dfeat), np.float32)
    else:
        b = np.zeros(dfeat, np.float32)
        s = np.ones(dfeat, np.float32)
    return dict(
        s_state=np.abs(f32(rng, bh, dfeat, dv, scale=0.1)),
        z_state=np.abs(f32(rng, bh, dfeat, scale=0.1)) + 0.1,
        q=f32(rng, bh, tlen, dh, scale=dh ** -0.25),
        k=f32(rng, bh, tlen, dh, scale=dh ** -0.25),
        v=f32(rng, bh, tlen, dv), w=w, b=b, s=s,
    )


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("kind", ["prf", "trig"])
@pytest.mark.parametrize("tlen,block_t", [(1, None), (5, None), (7, 4)])
def test_decode_block_matches_pallas(kind, precision, tlen, block_t):
    """Padded shapes (dh = 16, D = 40, dv = 24); T = 7 with block_t = 4 is
    one full block and one unpadded remainder launch."""
    rng = np.random.default_rng(tlen)
    a = _decode_inputs(rng, 3, tlen, 16, 40, 24, kind)
    names = ("s_state", "z_state", "q", "k", "v", "w", "b", "s")
    kw = dict(feature_kind=kind, normalize=kind == "prf", precision=precision)
    got = ops.rff_attention_decode_block(*(t(a[n]) for n in names),
                                         block_t=block_t, **kw)
    jargs = [jnp.asarray(a[n]) for n in names]
    want_pallas = rff_attention_decode_block_pallas(*jargs, interpret=True,
                                                    **kw)
    want_xla = jops.rff_attention_decode_block(*jargs, mode="xla",
                                               block_t=block_t, **kw)
    rel = BF16 if precision else F32
    for want in (want_pallas, want_xla):
        for g, w, what in zip(got, want, ("out", "S", "z")):
            close(g, w, rel, f"{kind} {precision} T={tlen} {what}")


@pytest.mark.parametrize("kind", ["prf", "trig"])
def test_decode_block_equals_per_token(kind):
    """A block of T ticks against T one-token blocks, at 1e-5 (not bit for
    bit on the CPU; see the module docstring)."""
    rng = np.random.default_rng(11)
    a = _decode_inputs(rng, 2, 6, 16, 32, 16, kind)
    kw = dict(feature_kind=kind, normalize=kind == "prf")
    common = (t(a["w"]), t(a["b"]), t(a["s"]))
    blk = ops.rff_attention_decode_block(
        t(a["s_state"]), t(a["z_state"]), t(a["q"]), t(a["k"]), t(a["v"]),
        *common, **kw)
    sm, zv, outs = t(a["s_state"]), t(a["z_state"]), []
    for i in range(6):
        o, sm, zv = ops.rff_attention_decode_block(
            sm, zv, t(a["q"][:, i:i + 1]), t(a["k"][:, i:i + 1]),
            t(a["v"][:, i:i + 1]), *common, **kw)
        outs.append(o)
    close(blk[0], torch.cat(outs, 1), F32, "outputs")
    close(blk[1], sm, F32, "S")
    close(blk[2], zv, F32, "z")


def test_decode_op_matches_repro():
    rng = np.random.default_rng(5)
    bh, dfeat, dv = 4, 32, 8
    args = (np.abs(f32(rng, bh, dfeat, dv)), np.abs(f32(rng, bh, dfeat)),
            np.abs(f32(rng, bh, dfeat)), np.abs(f32(rng, bh, dfeat)),
            f32(rng, bh, dv))
    got = ops.rff_attention_decode(*(t(x) for x in args))
    want = jops.rff_attention_decode(*(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        close(g, w, F32, "rff_attention_decode")


def _positive(rng, *shape):
    return (np.log1p(np.exp(rng.normal(size=shape))) + 0.01).astype(np.float32)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("slen,chunk", [(64, 16), (64, 64), (256, 16),
                                        (256, 64)])
def test_rff_attention_matches_pallas(slen, chunk, normalize):
    rng = np.random.default_rng(slen + chunk)
    bh, dfeat, dv = 3, 32, 16
    q, k = _positive(rng, bh, slen, dfeat), _positive(rng, bh, slen, dfeat)
    v = f32(rng, bh, slen, dv)
    got = ops.rff_attention(t(q), t(k), t(v), chunk=chunk,
                            normalize=normalize)
    want = rff_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=chunk,
                                normalize=normalize, interpret=True)
    close(got, want, RFF_F32, "chunked vs pallas")
    close(ref.rff_attention_ref(t(q), t(k), t(v), normalize=normalize), want,
          RFF_F32, "quadratic vs pallas")
    close(ref.rff_attention_state_ref(t(q), t(k), t(v),
                                      normalize=normalize)[0], want, RFF_F32,
          "recurrent vs pallas")


def test_rff_attention_rejects_ragged_chunk():
    x = torch.ones(1, 24, 4)
    with pytest.raises(ValueError, match="multiple"):
        ops.rff_attention(x, x, x, chunk=16)


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(causal, dh):
    rng = np.random.default_rng(dh)
    q, k, v = (f32(rng, 3, 128, dh) for _ in range(3))
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=32, block_k=32,
                                  causal=causal, interpret=True)
    close(got, want, F32, f"flash causal={causal} dh={dh}")


# Every head shape in src/repro/configs: deepseek-v2-lite's MLA (192, 128),
# minicpm3's (96, 64), recurrentgemma's 256.
CONFIG_HEADS = [(192, 128), (96, 64), (256, 256)]


@pytest.mark.parametrize("dh,dv", CONFIG_HEADS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_unequal_heads_match_pallas(causal, dh, dv):
    """ops.flash_attention(mode="auto") on CPU tensors with q/k and v heads
    of different widths against repro's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(dh + dv)
    q, k, v = f32(rng, 2, 64, dh), f32(rng, 2, 64, dh), f32(rng, 2, 64, dv)
    got = ops.flash_attention(t(q), t(k), t(v), mode="auto", causal=causal,
                              block_q=32, block_k=32)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=32, block_k=32,
                                  causal=causal, interpret=True)
    assert got.shape == (2, 64, dv)
    close(got, want, F32, f"flash causal={causal} ({dh}, {dv})")


@pytest.mark.parametrize("causal", [True, False])
def test_attention_dispatcher_matches_repro(causal):
    """The dispatcher's dense path and, above ``dense_threshold`` keys, its
    blocked online-softmax loop (GQA, with and without ``kv_len``) against
    repro's dispatcher on the CPU."""
    from repro.models.attention import flash_attention as jax_dispatch

    rng = np.random.default_rng(9)
    q = f32(rng, 2, 40, 4, 16)
    k, v = f32(rng, 2, 40, 2, 16), f32(rng, 2, 40, 2, 16)
    for threshold, block_k in ((8192, 1024), (16, 16)):
        for kv_len in (None, 30):
            kw = dict(causal=causal, block_k=block_k, kv_len=kv_len,
                      dense_threshold=threshold)
            want = jax_dispatch(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
            got = attention.flash_attention(t(q), t(k), t(v), **kw)
            close(got, want, F32, f"threshold={threshold} kv_len={kv_len}")


def test_prf_features_match_repro():
    """The port's PRF map against ``repro``'s on the same projection; the
    port's sampler draws orthogonal blocks with chi(d) norms."""
    from repro.core.rff import RFF as JaxRFF
    from repro.core.rff import positive_random_features as jax_prf

    rng = np.random.default_rng(3)
    omega, x = f32(rng, 16, 40), f32(rng, 5, 16, scale=0.5)
    got = positive_random_features(RFF(t(omega), torch.zeros(40)), t(x))
    want = jax_prf(JaxRFF(jnp.asarray(omega), jnp.zeros(40)), jnp.asarray(x))
    close(got, want, F32, "prf")
    feat = sample_prf(torch.Generator().manual_seed(0), 16, 40, device="cpu")
    block = feat.omega[:, :16]
    gram = block.T @ block
    off = gram - torch.diag(torch.diag(gram))
    assert float(off.abs().max()) < 1e-4  # orthogonal columns in a block
    assert torch.equal(feat.bias, torch.zeros(40))


# ---------------------------------------------------------------------------
# The model: every arch reduced, as published and with RFF attention, f32
# ---------------------------------------------------------------------------

# (arch, attention): each arch's own attention ("none" for mamba2), and
# "rff" for each attention-mixer arch (the hybrid's local attention stays
# GQA under with_rff_attention, as in repro).
CASES = ([(arch, get_config(arch).attention) for arch in ARCH_IDS]
         + [(arch, "rff") for arch in ARCH_IDS
            if get_config(arch).mixer == "attention"])


def _reduced(arch, get):
    """The arch's reduced config; the hybrid keeps two extra recurrent
    blocks after its group (recurrentgemma's 26 layers are 8 groups and
    2 extra)."""
    cfg = get(arch).reduced()
    if cfg.mixer == "rglru_hybrid":
        cfg = replace(cfg, num_layers=5)
    return cfg


@functools.lru_cache(maxsize=None)
def _model(arch, attn):
    """(repro cfg, repro params, port cfg, port params)."""
    jcfg = _reduced(arch, jax_get_config)
    cfg = _reduced(arch, get_config)
    if attn == "rff":
        jcfg = jt.with_rff_attention(jcfg)
        cfg = transformer.with_rff_attention(cfg)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return jcfg, params, cfg, tparams


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(jt.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(jt.forward, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jax_prefill(jcfg):
    return jax.jit(jax_make_prefill_step(jcfg))


def _tokens(seed, vocab, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _state_leaves(state):
    """A decode state's arrays in order (dicts by key, tuples by field,
    positions left out): the port's and repro's line up."""
    if isinstance(state, dict):  # jit returns dicts in key order
        return [a for k in sorted(state) for a in _state_leaves(state[k])]
    if isinstance(state, list):
        return [a for s in state for a in _state_leaves(s)]
    return [a for a in state[:-1]]


@pytest.mark.parametrize("arch,attn", CASES)
def test_forward_matches_repro(arch, attn):
    jcfg, params, cfg, tparams = _model(arch, attn)
    toks = _tokens(0, cfg.vocab_size, 2, 32)
    want = _jax_forward(jcfg)(params, jcfg, jnp.asarray(toks))
    got = transformer.forward(tparams, cfg, t(toks).long())
    close(got[..., :cfg.vocab_size], np.asarray(want)[..., :cfg.vocab_size],
          F32, "logits")
    assert bool((got[..., cfg.vocab_size:] == -1e30).all())


@pytest.mark.parametrize("arch,attn", CASES)
def test_prefill_step_matches_repro(arch, attn):
    jcfg, params, cfg, tparams = _model(arch, attn)
    toks = _tokens(1, cfg.vocab_size, 2, 32)
    want = _jax_prefill(jcfg)(params, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(cfg)(tparams, {"tokens": t(toks).long()})
    close(got, want, F32, "prefill logits")


@pytest.mark.parametrize("arch,attn", CASES)
def test_decode_steps_match_repro(arch, attn):
    """Teacher-forced: 12 decode steps from an empty state, the same
    tokens into both."""
    jcfg, params, cfg, tparams = _model(arch, attn)
    toks = _tokens(2, cfg.vocab_size, 2, 12)
    jstate = jt.decode_state_init(jcfg, 2, max_len=16)
    state = transformer.decode_state_init(cfg, 2, 16, device="cpu")
    step = make_decode_step(cfg)
    jstep = _jax_decode(jcfg)
    for i in range(12):
        want, jstate = jstep(params, jcfg, jstate, jnp.asarray(toks[:, i]))
        got, state = step(tparams, state, {"token": t(toks[:, i]).long()})
        close(got, want, F32, f"step {i}")
    mine, theirs = _state_leaves(state), _state_leaves(jstate)
    assert len(mine) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(mine, theirs)):
        close(a, b, F32, f"state leaf {i}")


@pytest.mark.parametrize("arch,attn", CASES)
def test_generate_matches_repro(arch, attn):
    """Greedy generation: the port's logits along repro's token path, and
    the port's tokens where repro's top-two margin is clear of the logits'
    tolerance (random weights can tie across frameworks)."""
    jcfg, params, cfg, tparams = _model(arch, attn)
    prompt = _tokens(3, cfg.vocab_size, 2, 4)
    steps, max_len = 8, 16
    jtoks = np.asarray(jax_generate(params, jcfg, jnp.asarray(prompt),
                                    steps=steps, max_len=max_len))
    # repro's logits along its own path, by teacher forcing.
    jstep = _jax_decode(jcfg)
    jstate = jt.decode_state_init(jcfg, 2, max_len=max_len)
    for i in range(prompt.shape[1]):
        lg, jstate = jstep(params, jcfg, jstate, jnp.asarray(prompt[:, i]))
    want = []
    for i in range(steps):
        want.append(np.asarray(lg))
        lg, jstate = jstep(params, jcfg, jstate, jnp.asarray(jtoks[:, i]))
    want = np.stack(want, axis=1)
    assert np.array_equal(jtoks, want.argmax(-1))
    got = path_logits(tparams, cfg, t(prompt).long(), t(jtoks).long(),
                      max_len=max_len)
    close(got, want, F32, "logits along repro's path")
    toks = generate(tparams, cfg, t(prompt).long(), steps=steps,
                    max_len=max_len)
    seen = path_logits(tparams, cfg, t(prompt).long(), toks, max_len=max_len)
    assert torch.equal(toks, seen.argmax(-1))
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    for row in range(2):
        for i in range(steps):
            if not clear[row, i]:
                break  # a near tie: the two paths may part here
            assert int(toks[row, i]) == int(jtoks[row, i]), (row, i)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_returns_int32_tokens(temperature):
    """repro's generate returns int32 tokens (serve/serve_loop.py); so does
    the port's, greedy and sampled."""
    jcfg, params, cfg, tparams = _model("qwen2-0.5b", "rff")
    prompt = _tokens(4, cfg.vocab_size, 2, 3)
    want = jax_generate(params, jcfg, jnp.asarray(prompt), steps=3,
                        max_len=8, temperature=temperature,
                        rng=jax.random.PRNGKey(0))
    toks = generate(tparams, cfg, t(prompt).long(), steps=3, max_len=8,
                    temperature=temperature,
                    generator=torch.Generator().manual_seed(0))
    assert np.asarray(want).dtype == np.int32
    assert toks.dtype == torch.int32 and toks.shape == (2, 3)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


@pytest.mark.parametrize("kind", ["prf", "trig"])
def test_prefill_then_decode_matches_apply(kind):
    """Prefill 6 tokens as one decode block, decode 4 more one by one: the
    concatenation equals repro's full-sequence rff_attn_apply
    (tests/test_decode.py:207)."""
    jcfg, params, cfg, tparams = _model("llama3-8b", "rff")
    jp = params["blocks_list"][0]["attn"]
    p = tparams["blocks"][0]["attn"]
    x = f32(np.random.default_rng(4), 2, 10, cfg.d_model, scale=0.1)
    want = jrff.rff_attn_apply(jp, jcfg, jnp.asarray(x), feature_kind=kind)
    st = trff.rff_state_init(cfg, 2, device="cpu")
    pre, st = trff.rff_attn_decode_block(p, cfg, t(x[:, :6]), st,
                                         feature_kind=kind)
    outs = [pre]
    for i in range(6, 10):
        o, st = trff.rff_attn_decode(p, cfg, t(x[:, i:i + 1]), st,
                                     feature_kind=kind)
        outs.append(o)
    assert st.pos == 10
    close(torch.cat(outs, 1), want, F32, f"{kind} decode vs apply")
    got = trff.rff_attn_apply(p, cfg, t(x), feature_kind=kind)
    close(got, want, F32, f"{kind} apply")


def test_rff_attn_feature_map_matches_repro():
    """rff_attn_init(feature_map=...) takes a trig map's buffers as they
    are; decode from it agrees with repro's full-sequence apply with the
    same map, and a map of the wrong shape is refused."""
    from repro_torch.features import rff_map

    jcfg, params, cfg, tparams = _model("llama3-8b", "rff")
    fm = rff_map(torch.Generator().manual_seed(2), cfg.resolved_head_dim,
                 cfg.rff_num_features, 1.0, device="cpu")
    p = trff.rff_attn_init(torch.Generator().manual_seed(0), cfg,
                           feature_map=fm, device="cpu")
    tf = fm.trig  # rff_map returns a FeatureMap, as repro's does
    for name, buf in zip(("omega", "bias", "scale"), tf):
        assert torch.equal(p[name], buf)
    jp = dict(params["blocks_list"][0]["attn"])
    jp.update(omega=jnp.asarray(tf.omega.numpy()),
              bias=jnp.asarray(tf.bias.numpy()),
              scale=jnp.asarray(tf.scale.numpy()))
    p = dict(tparams["blocks"][0]["attn"], omega=tf.omega, bias=tf.bias,
             scale=tf.scale)
    x = f32(np.random.default_rng(8), 2, 6, cfg.d_model, scale=0.1)
    want = jrff.rff_attn_apply(jp, jcfg, jnp.asarray(x), feature_kind="trig")
    got, _ = trff.rff_attn_decode_block(
        p, cfg, t(x), trff.rff_state_init(cfg, 2, device="cpu"),
        feature_kind="trig")
    close(got, want, F32, "trig map decode vs repro apply")
    bad = rff_map(torch.Generator().manual_seed(2), cfg.resolved_head_dim + 1,
                  cfg.rff_num_features, 1.0, device="cpu")
    with pytest.raises(ValueError, match="feature_map"):
        trff.rff_attn_init(torch.Generator(), cfg, feature_map=bad,
                           device="cpu")


def test_lm_params_stacked_and_list_layouts_agree():
    """repro's stacked "blocks" (scan_layers=True) and "blocks_list"
    layouts of the same weights give the same port model, for a layer
    stack and for the hybrid's groups with their extra blocks; a tree of
    the wrong depth is refused."""
    for arch, attn in (("qwen2-0.5b", "rff"), ("recurrentgemma-2b", "gqa")):
        jcfg, params, cfg, tparams = _model(arch, attn)
        stacked = {k: v for k, v in params.items() if k != "blocks_list"}
        stacked["blocks"] = jax.tree.map(lambda *xs: jnp.stack(xs),
                                         *params["blocks_list"])
        got = convert.lm_params(jax.tree.map(np.asarray, stacked), cfg,
                                device="cpu")
        assert len(got.get("extra", [])) == transformer.num_scan_layers(cfg)[1]
        toks = t(_tokens(5, cfg.vocab_size, 1, 16)).long()
        close(transformer.forward(got, cfg, toks),
              transformer.forward(tparams, cfg, toks), 0.0, f"{arch} layouts")
        want = jt.forward(stacked, replace(jcfg, scan_layers=True),
                          jnp.asarray(toks.numpy()))
        close(transformer.forward(got, cfg, toks), want, F32,
              f"{arch} stacked vs repro")
    hybrid = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="extra"):
        convert.lm_params(dict(hybrid, extra=hybrid["extra"][:1]), cfg,
                          device="cpu")


def test_kv_cache_and_rff_state_converters():
    """Each state type of repro as the port's, leaf for leaf, and whole
    decode states (the list and the stacked layouts)."""
    jcfg, params, cfg, tparams = _model("qwen2-0.5b", "gqa")
    rng = np.random.default_rng(6)
    k, v = f32(rng, 2, 8, 2, 16), f32(rng, 2, 8, 2, 16)
    cache = convert.kv_cache(k, v, np.int32(3), device="cpu")
    assert cache.pos == 3 and np.array_equal(cache.k.numpy(), k)
    s, z = f32(rng, 2, 4, 32, 16), f32(rng, 2, 4, 32)
    st = convert.rff_state(s, z, np.int32(5), device="cpu")
    assert st.pos == 5 and np.array_equal(st.z.numpy(), z)
    c, r = f32(rng, 2, 8, 32), f32(rng, 2, 8, 8)
    mc = convert.mla_cache(c, r, np.int32(2), device="cpu")
    assert mc.pos == 2 and np.array_equal(mc.k_rope.numpy(), r)
    h, conv = f32(rng, 2, 8, 16, 16), f32(rng, 2, 3, 160)
    ms = convert.mamba2_state(h, conv, np.int32(4), device="cpu")
    assert ms.pos == 4 and np.array_equal(ms.conv.numpy(), conv)
    h, conv = f32(rng, 2, 4, 16), f32(rng, 2, 3, 4, 16)
    rs = convert.rglru_state(h, conv, np.int32(1), device="cpu")
    assert rs.pos == 1 and np.array_equal(rs.h.numpy(), h)
    for arch, attn in (("recurrentgemma-2b", "gqa"),
                       ("deepseek-v2-lite-16b", "mla"),
                       ("mamba2-130m", "none"), ("llama3-8b", "rff")):
        jcfg, params, cfg, tparams = _model(arch, attn)
        js = jt.decode_state_init(jcfg, 2, max_len=8)
        toks = _tokens(9, cfg.vocab_size, 2, 3)
        for i in range(3):
            _, js = _jax_decode(jcfg)(params, jcfg, js,
                                      jnp.asarray(toks[:, i]))
        stacked = dict(js, stack=jax.tree.map(lambda *xs: jnp.stack(xs),
                                              *js["stack"]))
        for tree in (js, stacked):
            got = convert.decode_state(jax.tree.map(np.asarray, tree), cfg,
                                       device="cpu")
            mine, theirs = _state_leaves(got), _state_leaves(js)
            assert len(mine) == len(theirs) > 0
            for a, b in zip(mine, theirs):
                assert np.array_equal(a.numpy(), np.asarray(b))
        # The converted state decodes on as repro's does.
        want, _ = _jax_decode(jcfg)(params, jcfg, js, jnp.asarray(toks[:, 0]))
        lg, _ = transformer.decode_step(tparams, cfg, got,
                                        t(toks[:, 0]).long())
        close(lg, want, F32, f"{arch} decode from a converted state")


# ---------------------------------------------------------------------------
# Rules, registry and entry points
# ---------------------------------------------------------------------------


def test_default_decode_block_t_rule():
    """The port's rule (the kernel's T costs no shared memory): the cap of
    512 whenever a head's state fits a block, the floor of 8 otherwise."""
    assert chunking.default_decode_block_t(256, 64, 64) == 512  # qwen2
    assert chunking.default_decode_block_t(256, 128, 128) == 512  # llama3
    assert chunking.default_decode_block_t(40, 24, 16) == 512
    assert not chunking.decode_fits(1024, 128, 128)
    assert chunking.default_decode_block_t(1024, 128, 128) == 8
    assert chunking.decode_smem_bytes(256, 128, 128) <= chunking.SMEM_BUDGET
    assert chunking.linear_attention_smem_bytes(256) <= chunking.SMEM_BUDGET


@pytest.mark.parametrize("bh,slen,dfeat,dv", [
    (56, 2048, 256, 64),   # qwen2-0.5b's prefill at B = 4, S = 2048
    (8, 4096, 256, 64),    # chip_smoke's long sequence
    (3, 100, 40, 24),      # ragged S, D and dv
    (2, 192, 64, 200),     # a ragged fourth dv tile
])
def test_linear_attention_plan(bh, slen, dfeat, dv):
    """Kernel 10's launches: chunks of 64 rows, dv tiles of 64, D rounded
    up to 32; the state walks 64 features a block; the workspace holds each
    (head, chunk)'s S_prev and z_prev, 4 BH nc (tiles Dp 64 + Dp) bytes; at
    the LM shape each launch has more blocks than the card's 132 SMs."""
    plan = chunking.linear_attention_plan(bh, slen, dfeat, dv)
    nc, tiles, dp = -(-slen // 64), -(-dv // 64), -(-dfeat // 32) * 32
    assert (plan.nc, plan.tiles, plan.dp) == (nc, tiles, dp)
    assert plan.workspace_bytes == 4 * bh * nc * (tiles * dp * 64 + dp)
    assert plan.output_blocks == bh * nc * tiles
    assert plan.state_blocks == bh * tiles * -(-dp // 64)
    if (bh, slen, dfeat, dv) == (56, 2048, 256, 64):
        assert min(plan.state_blocks, plan.output_blocks) >= 132
        assert (plan.state_blocks, plan.output_blocks) == (224, 1792)
        assert plan.workspace_bytes == 119_275_520


def test_decode_block_tile_smem():
    """Kernel 9's blocks own 32 dv columns of a head (112 blocks at
    qwen2-0.5b's decode, 56 heads of dv = 64): a block's shared memory
    follows its tile, with W beside it where it fits, whatever dv; while
    decode_fits answers for the head's whole state."""
    assert chunking.DECODE_TILE_COLS == 32
    assert chunking.decode_smem_bytes(256, 64, 64) == \
        chunking.decode_smem_bytes(256, 128, 64)
    assert chunking.decode_smem_bytes(256, 64, 64) == 4 * (
        256 * 32 + 2 * 32 + 8 * 32 + 3 * 256 + 4 * 64 + 8 + 4 + 64 * 256)
    # W (128, 1024) does not fit beside a (1024, 32) tile: read from L2.
    assert chunking.decode_smem_bytes(1024, 128, 128) == 4 * (
        1024 * 32 + 2 * 32 + 8 * 32 + 3 * 1024 + 4 * 128 + 8 + 4)
    assert chunking.decode_smem_bytes(1024, 128, 128) <= chunking.SMEM_BUDGET
    assert chunking.decode_fits(256, 128, 128)
    assert not chunking.decode_fits(1024, 128, 128)


def test_registry_matches_repro():
    """The port's registry names repro's ten archs, each config field for
    field repro's and with its param_count."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert asdict(get_config(arch)) == asdict(jax_get_config(arch))
        assert (get_config(arch).param_count()
                == jax_get_config(arch).param_count())
        assert (get_config(arch).active_param_count()
                == jax_get_config(arch).active_param_count())
    assert get_config("qwen2-0.5b").activation_dtype == torch.bfloat16


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    with pytest.raises(KeyError):
        jax_get_config("gpt-5")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.decode_state_init(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_params({}, cfg)
    x = torch.ones(1, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(x, x, x, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rff_attention(x, x, x, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention(x[:, :, None], x[:, :, None],
                                  x[:, :, None], kernel_mode="cuda")


_INIT_HELPERS = {
    "dense_init": lambda cfg, **kw: layers.dense_init(
        torch.Generator(), 8, 4, **kw),
    "rmsnorm_init": lambda cfg, **kw: layers.rmsnorm_init(8, **kw),
    "embed_init": lambda cfg, **kw: layers.embed_init(
        torch.Generator(), 16, 8, **kw),
    "glu_mlp_init": lambda cfg, **kw: layers.glu_mlp_init(
        torch.Generator(), 8, 16, **kw),
    "head_proj_init": lambda cfg, **kw: attention.head_proj_init(
        torch.Generator(), 8, 2, 4, **kw),
    "head_out_init": lambda cfg, **kw: attention.head_out_init(
        torch.Generator(), 2, 4, 8, **kw),
    "gqa_init": lambda cfg, **kw: attention.gqa_init(
        torch.Generator(), cfg, **kw),
    "rff_attn_init": lambda cfg, **kw: trff.rff_attn_init(
        torch.Generator(), cfg, **kw),
    "rff_state_init": lambda cfg, **kw: trff.rff_state_init(cfg, 1, **kw),
    "mla_init": lambda cfg, **kw: attention.mla_init(
        torch.Generator(), get_config("minicpm3-4b").reduced(), **kw),
    "moe_init": lambda cfg, **kw: moe.moe_init(
        torch.Generator(), get_config("deepseek-v2-lite-16b").reduced(),
        **kw),
    "mamba2_init": lambda cfg, **kw: ssm.mamba2_init(
        torch.Generator(), get_config("mamba2-130m").reduced(), **kw),
    "mamba2_state_init": lambda cfg, **kw: ssm.mamba2_state_init(
        get_config("mamba2-130m").reduced(), 1, **kw),
    "rglru_init": lambda cfg, **kw: rglru.rglru_init(
        torch.Generator(), get_config("recurrentgemma-2b").reduced(), **kw),
    "rglru_state_init": lambda cfg, **kw: rglru.rglru_state_init(
        get_config("recurrentgemma-2b").reduced(), 1, **kw),
    "stub_embeddings": lambda cfg, **kw: stub_embeddings(
        torch.Generator(), get_config("internvl2-2b").reduced(), 1, 4, **kw),
    "decode_state_init": lambda cfg, **kw: transformer.decode_state_init(
        _reduced("recurrentgemma-2b", get_config), 1, 8, **kw),
}


def _leaves(x):
    """Every tensor in a nested dict, list or tuple."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


@pytest.mark.parametrize("helper", sorted(_INIT_HELPERS))
def test_model_init_helpers_default_to_cuda(helper):
    """Like init_params, every init helper of the model places its tensors
    on the card unless the caller asks for the CPU: without a card the
    default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = transformer.with_rff_attention(get_config("qwen2-0.5b").reduced())
    make = _INIT_HELPERS[helper]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make(cfg)
    leaves = _leaves(make(cfg, device="cpu"))
    assert leaves
    for leaf in leaves:
        assert leaf.device.type == "cpu"


@pytest.mark.parametrize("dtype,dh,route,source,entry,width", [
    (torch.bfloat16, 64, "tensor_core", "flash_attention_sm90",
     "flash_attention_bf16", 64),
    (torch.bfloat16, 24, "tensor_core", "flash_attention_sm90",
     "flash_attention_bf16", 24),
    (torch.bfloat16, 20, "tensor_core", "flash_attention_sm90",
     "flash_attention_bf16", 24),
    (torch.bfloat16, 1, "tensor_core", "flash_attention_sm90",
     "flash_attention_bf16", 8),
    (torch.bfloat16, 128, "tensor_core", "flash_attention_sm90",
     "flash_attention_bf16", 128),
    (torch.float32, 20, "cuda_core", "flash_attention", "flash_attention",
     20),
    (torch.float32, 128, "cuda_core", "flash_attention", "flash_attention",
     128),
])
def test_flash_route_rule(dtype, dh, route, source, entry, width):
    """bf16 goes to the tensor-core kernel, its head padded to a multiple
    of 8 columns (TMA's 16-byte rows); f32 to the CUDA-core kernel as it
    is. The tensor-core kernel always runs 128 query rows; the CUDA-core
    kernel 64 rows at a short S (one 64-key tile: 128 rows would be half
    padding) and 128 at a long one: 8 rows a thread up to dv = 64 where
    two blocks fit an SM, else 4 rows a thread."""
    from repro_torch.kernels.flash_attention import flash_plan

    x = torch.zeros(2, 5, dh, dtype=dtype)
    assert flash_plan(x, x, x)[:4] == (route, source, entry, width)
    tiles = []
    for slen in (5, 64, 65, 2048):
        y = torch.zeros(1, slen, dh, dtype=dtype)
        plan = flash_plan(y, y, y)
        tiles.append((plan.query_tile, plan.thread_rows))
        assert plan.smem_bytes <= chunking.SMEM_BUDGET
    assert tiles == (F32_TILES[dh] if route == "cuda_core"
                     else [(128, 0)] * 4)


# (query rows, rows a thread) of the CUDA-core kernel at S = 5, 64, 65 and
# 2048.
F32_TILES = {20: [(64, 2)] * 2 + [(128, 8)] * 2,
             128: [(64, 2)] * 2 + [(128, 4)] * 2}


@pytest.mark.parametrize("dh,dv", CONFIG_HEADS)
def test_flash_plan_takes_config_heads(dh, dv):
    """Both routes take the config heads: q/k and v padded apart, the bf16
    ring in 64-key tiles above a padded dh of 192 and one launch for each
    128 columns of V, every block within the shared-memory budget. The f32
    route runs 64-key tiles, and its query tile follows (dh, dv, S): 64
    rows at a short S, 128 at a long one where dv <= 128 (4 rows a thread
    for these heads: minicpm3's (96, 64) does not fit two blocks an SM at
    8 rows a thread)."""
    from repro_torch.kernels.flash_attention import flash_plan

    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(2, 5, dh, dtype=dtype)
        plan = flash_plan(q, q, torch.zeros(2, 5, dv, dtype=dtype))
        assert (plan.width, plan.v_width) == (dh, dv)
        assert plan.smem_bytes <= chunking.SMEM_BUDGET
        assert sum(cols for _, cols in plan.passes) == dv
        if dtype == torch.float32:
            long_q = torch.zeros(1, 2048, dh, dtype=dtype)
            long_plan = flash_plan(long_q, long_q,
                                   torch.zeros(1, 2048, dv, dtype=dtype))
            assert plan.passes == ((0, dv),) and plan.key_tile == 64
            assert long_plan.key_tile == 64
            assert tuple((p.query_tile, p.thread_rows)
                         for p in (plan, long_plan)) == \
                CONFIG_HEAD_TILES[dh, dv]
            assert long_plan.smem_bytes <= chunking.SMEM_BUDGET
        else:
            assert plan.key_tile == (64 if dh > 192 else 128)
            assert all(cols <= 128 for _, cols in plan.passes)
    bf = flash_plan(*(torch.zeros(1, 3, 256, dtype=torch.bfloat16),) * 3)
    assert bf.passes == ((0, 128), (128, 128))


# The f32 route's (query rows, rows a thread) at S = 5 and S = 2048 for
# each CONFIG_HEADS entry.
CONFIG_HEAD_TILES = {(192, 128): ((64, 2), (128, 4)),
                     (96, 64): ((64, 2), (128, 4)),
                     (256, 256): ((64, 2), (64, 2))}


def _config_heads():
    """(dh, dv) of every attention head in the configs, as published and
    reduced."""
    heads = set()
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            if cfg.mla is not None:
                m = cfg.mla
                heads.add((m.qk_nope_head_dim + m.qk_rope_head_dim,
                           m.v_head_dim))
            else:
                heads.add((cfg.resolved_head_dim,) * 2)
    return sorted(heads)


def test_flash_cuda_core_tiles_fit_the_budget():
    """Every tile the f32 route can pick, at every config head and at a
    sweep of widths and lengths, fits chunking.SMEM_BUDGET, and the plan's
    shared memory is _smem_bytes of its tile."""
    from repro_torch.kernels.flash_attention import (
        CUDA_CORE_KEYS,
        CUDA_CORE_TILES,
        SM_SHARED,
        _cuda_core_tile,
        _smem_bytes,
        flash_plan,
    )

    heads = _config_heads()
    assert (64, 64) in heads and (192, 128) in heads and (16, 16) in heads
    picked = set()
    for dh, dv in heads:
        for slen in (1, 63, 64, 65, 128, 2048):
            q = torch.zeros(1, slen, dh)
            plan = flash_plan(q, q, torch.zeros(1, slen, dv))
            tile = (plan.query_tile, plan.thread_rows)
            assert plan.smem_bytes == _smem_bytes(
                "cuda_core", plan.width, plan.v_width, CUDA_CORE_KEYS,
                plan.query_tile)
            assert plan.smem_bytes <= chunking.SMEM_BUDGET
            assert dv <= CUDA_CORE_TILES[tile]
            picked.add(tile)
    assert picked == {(64, 2), (128, 4), (128, 8)}
    for width in range(4, 257, 4):
        for v_width in range(4, 257, 4):
            for slen in (64, 65):
                rows, thread_rows = _cuda_core_tile(width, v_width, slen)
                assert v_width <= CUDA_CORE_TILES[rows, thread_rows]
                smem = _smem_bytes("cuda_core", width, v_width,
                                   CUDA_CORE_KEYS, rows)
                two_blocks = 2 * (smem + 1024) <= SM_SHARED
                assert (thread_rows == 8) == (rows == 128 and v_width <= 64
                                              and two_blocks)
                assert (rows == 128) == (slen > 64 and v_width <= 128
                                         and _smem_bytes(
                                             "cuda_core", width, v_width,
                                             CUDA_CORE_KEYS, 128)
                                         <= chunking.SMEM_BUDGET)
                assert smem <= chunking.SMEM_BUDGET


def test_flash_cuda_core_pads_to_four():
    """The f32 route pads q/k and v heads to multiples of 4 (the kernel's
    16-byte copies) and says the padded widths; its row stride keeps the
    width where width / 4 is odd and adds 4 where it is even."""
    from repro_torch.kernels.flash_attention import _qk_ld, flash_plan

    q = torch.zeros(2, 70, 6)
    plan = flash_plan(q, q, torch.zeros(2, 70, 10))
    assert (plan.width, plan.v_width, plan.passes) == (8, 12, ((0, 12),))
    assert [_qk_ld(w) for w in (4, 8, 16, 20, 64, 96, 192, 256)] == \
        [4, 12, 20, 20, 68, 100, 196, 260]


def test_flash_route_refusals():
    """Both routes take q/k and v heads up to 256 and f32 or bf16 only;
    q and k must agree, and v must share their heads and length."""
    from repro_torch.kernels.flash_attention import flash_plan

    for dtype in (torch.float32, torch.bfloat16):
        big = torch.zeros(1, 4, 264, dtype=dtype)
        ok = torch.zeros(1, 4, 64, dtype=dtype)
        with pytest.raises(ValueError, match="head dim"):
            flash_plan(big, big, big)
        with pytest.raises(ValueError, match="v head dim"):
            flash_plan(ok, ok, big)
        with pytest.raises(ValueError, match="k has shape"):
            flash_plan(ok, torch.zeros(1, 4, 32, dtype=dtype), ok)
        with pytest.raises(ValueError, match="v has shape"):
            flash_plan(ok, ok, torch.zeros(1, 5, 64, dtype=dtype))
    half = torch.zeros(1, 4, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_plan(half, half, half)
    x = torch.zeros(1, 4, 16)
    with pytest.raises(TypeError):
        flash_plan(x, x, x.to(torch.bfloat16))


def test_launch_serve_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--arch", "qwen2-0.5b", "--rff", "--tokens", "4",
         "--prompt-len", "3", "--batch", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "attention=rff" in proc.stdout and "sample:" in proc.stdout
