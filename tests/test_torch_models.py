"""The port's LM modules (MoE, MLA, mamba2, RG-LRU, the windowed and ring
attention, the frontend input) held against ``repro`` on the CPU.

Each test gives both packages the same numpy inputs, seeded, at the
reduced configs (``ModelConfig.reduced()``); parameters come from
``repro``'s inits and are carried over as they are. The whole models of
all ten archs are held in ``tests/test_torch_lm.py``.

Tolerances, of max|want| (``close``):
* 1e-5 wherever the two compute the same products in f32: MoE, MLA, the
  windowed and ring attention, the frontend input;
* mamba2's chunked SSD: 1e-5 as well (exp of differences of cumulative
  log-decays; measured within it, ROADMAP §3);
* the RG-LRU: 1e-5 (the port composes a chunk's recurrence by a
  Hillis-Steele scan, ``repro`` by ``associative_scan``: the same combine
  in another order; ROADMAP §3).
The MoE routing (experts, slots, drops) is compared exactly, and with
ties the lower expert index wins, as in ``jax.lax.top_k``.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, rglru, ssm, transformer
from repro_torch.models.frontend import stub_embeddings
from repro_torch.train.steps import make_decode_step, make_prefill_step

F32 = 1e-5


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


def tp(tree):
    """A numpy (or JAX) parameter tree as torch tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: tp(v) for k, v in tree.items()}
    return t(np.asarray(tree))


def cfgs(arch, **kw):
    """(repro's reduced config, the port's), with ``kw`` replaced in
    both."""
    return (replace(jax_get_config(arch).reduced(), **kw),
            replace(get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _dense_dispatch(expert, slot, keep, n_exp, capacity):
    """The port's routing as repro's (B, S, E, C) dispatch tensor."""
    b, s, k = expert.shape
    out = np.zeros((b, s, n_exp, capacity), np.float32)
    for bi in range(b):
        for si in range(s):
            for j in range(k):
                if keep[bi, si, j]:
                    out[bi, si, expert[bi, si, j], slot[bi, si, j]] = 1.0
    return out


@pytest.mark.parametrize("arch,factor", [
    ("deepseek-v2-lite-16b", 1.25), ("arctic-480b", 1.25),
    ("deepseek-v2-lite-16b", 0.5), ("arctic-480b", 0.3)])
def test_moe_apply_matches_repro(arch, factor):
    """Outputs at 1e-5, and the same experts, slots and drops; the small
    capacity factors drop tokens."""
    jcfg, cfg = cfgs(arch)
    jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=factor))
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=factor))
    params = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = f32(np.random.default_rng(0), 2, 24, cfg.d_model)
    want = jmoe.moe_apply(params, jcfg, jnp.asarray(x))
    got = moe.moe_apply(tp(params), cfg, t(x))
    close(got, want, F32, f"{arch} moe")

    m = cfg.moe
    capacity = max(1, int(m.top_k * 24 * factor / m.num_experts))
    gates = np.asarray(jax.nn.softmax(jnp.asarray(x) @ params["router"]["w"]))
    jdisp, _ = jmoe._dispatch_combine(jnp.asarray(gates), m.top_k, capacity)
    expert, slot, keep, _ = moe.route(t(gates), m.top_k, capacity)
    mine = _dense_dispatch(expert.numpy(), slot.numpy(), keep.numpy(),
                           m.num_experts, capacity)
    assert np.array_equal(mine, np.asarray(jdisp))
    if factor < 1:
        assert not bool(keep.all())  # tokens were dropped


def test_moe_ties_take_the_lower_index_as_lax_top_k():
    """Equal gates: the lower expert index first, in the top k and so in
    the slots, as jax.lax.top_k orders them; also at bf16 with many ties."""
    rng = np.random.default_rng(1)
    flat = np.full((2, 9, 8), 0.125, np.float32)
    levels = rng.integers(0, 3, (2, 9, 8)).astype(np.float32) / 4
    for gates in (flat, levels):
        for k in (1, 2, 3):
            jv, ji = jax.lax.top_k(jnp.asarray(gates), k)
            v, i = moe.top_k_lower_first(t(gates), k)
            assert np.array_equal(i.numpy(), np.asarray(ji))
            assert np.array_equal(v.numpy(), np.asarray(jv))
            jdisp, jcomb = jmoe._dispatch_combine(jnp.asarray(gates), k, 4)
            expert, slot, keep, gate = moe.route(t(gates), k, 4)
            assert np.array_equal(
                _dense_dispatch(expert.numpy(), slot.numpy(), keep.numpy(),
                                8, 4), np.asarray(jdisp))
    bf = t(levels).to(torch.bfloat16)
    _, ji = jax.lax.top_k(jnp.asarray(levels, jnp.bfloat16), 3)
    assert np.array_equal(moe.top_k_lower_first(bf, 3)[1].numpy(),
                          np.asarray(ji))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,pad", [("deepseek-v2-lite-16b", 0),
                                      ("minicpm3-4b", 0), ("minicpm3-4b", 6)])
def test_mla_apply_and_decode_match_repro(arch, pad):
    """Full-sequence MLA, then 10 decode steps from an empty latent cache
    (outputs and cache), with and without padded heads."""
    jcfg, cfg = cfgs(arch, pad_heads_to=pad)
    params = jattn.mla_init(jax.random.PRNGKey(4), jcfg)
    p = tp(params)
    x = f32(np.random.default_rng(2), 2, 16, cfg.d_model)
    close(attention.mla_apply(p, cfg, t(x)),
          jattn.mla_apply(params, jcfg, jnp.asarray(x)), F32, "mla apply")
    m = cfg.mla
    jc = jattn.MLACache(c_kv=jnp.zeros((2, 12, m.kv_lora_rank)),
                        k_rope=jnp.zeros((2, 12, m.qk_rope_head_dim)),
                        pos=jnp.zeros((), jnp.int32))
    c = convert.mla_cache(*(np.asarray(a) for a in jc), device="cpu")
    jdec = jax.jit(jattn.mla_decode, static_argnums=1)
    for i in range(10):
        want, jc = jdec(params, jcfg, jnp.asarray(x[:, i:i + 1]), jc)
        got, c = attention.mla_decode(p, cfg, t(x[:, i:i + 1]), c)
        close(got, want, F32, f"mla decode {i}")
    assert c.pos == int(jc.pos) == 10
    close(c.c_kv, jc.c_kv, F32, "latent cache")
    close(c.k_rope, jc.k_rope, F32, "rope cache")


# ---------------------------------------------------------------------------
# Windowed GQA and the ring decode
# ---------------------------------------------------------------------------


def test_gqa_window_matches_repro():
    jcfg, cfg = cfgs("recurrentgemma-2b")
    params = jattn.gqa_init(jax.random.PRNGKey(5), jcfg)
    x = f32(np.random.default_rng(3), 2, 24, cfg.d_model)
    for window in (0, 5):
        close(attention.gqa_apply(tp(params), cfg, t(x), window=window,
                                  block_k=8),
              jattn.gqa_apply(params, jcfg, jnp.asarray(x), window=window,
                              block_k=8), F32, f"window {window}")


def test_ring_gqa_decode_matches_repro_past_the_wrap():
    """A ring of 6 slots over 20 tokens: every output, and the ring's
    contents after it has wrapped three times."""
    jcfg, cfg = cfgs("recurrentgemma-2b", local_window=6)
    params = jattn.gqa_init(jax.random.PRNGKey(6), jcfg)
    p = tp(params)
    x = f32(np.random.default_rng(4), 2, 20, cfg.d_model)
    shape = (2, 6, cfg.num_kv_heads, cfg.resolved_head_dim)
    jc = jattn.KVCache(k=jnp.zeros(shape), v=jnp.zeros(shape),
                       pos=jnp.zeros((), jnp.int32))
    c = convert.kv_cache(np.zeros(shape, np.float32),
                         np.zeros(shape, np.float32), 0, device="cpu")
    jdec = jax.jit(jt._ring_gqa_decode, static_argnums=1)
    for i in range(20):
        want, jc = jdec(params, jcfg, jnp.asarray(x[:, i:i + 1]), jc)
        got, c = attention.ring_gqa_decode(p, cfg, t(x[:, i:i + 1]), c)
        close(got, want, F32, f"ring step {i}")
    close(c.k, jc.k, F32, "ring k")
    close(c.v, jc.v, F32, "ring v")
    # The ring's decode equals the windowed full-sequence attention.
    close(got[:, 0], attention.gqa_apply(p, cfg, t(x), window=6)[:, -1],
          F32, "ring vs window")


def test_ring_decode_masks_padded_heads():
    """With padded heads the port's ring decode equals its windowed
    forward (the padded heads are inert); repro's ring decode leaves them
    unmasked, and equals the port once their output rows are zero."""
    jcfg, cfg = cfgs("recurrentgemma-2b", local_window=4, pad_heads_to=6)
    params = jattn.gqa_init(jax.random.PRNGKey(7), jcfg)
    p = tp(params)
    x = f32(np.random.default_rng(5), 1, 9, cfg.d_model)
    shape = (1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    c = convert.kv_cache(np.zeros(shape, np.float32),
                         np.zeros(shape, np.float32), 0, device="cpu")
    outs = []
    for i in range(9):
        o, c = attention.ring_gqa_decode(p, cfg, t(x[:, i:i + 1]), c)
        outs.append(o)
    close(torch.cat(outs, 1), attention.gqa_apply(p, cfg, t(x), window=4),
          F32, "padded ring vs window")
    zeroed = dict(params, wo={"w": params["wo"]["w"].at[4:].set(0.0)})
    jc = jattn.KVCache(k=jnp.zeros(shape), v=jnp.zeros(shape),
                       pos=jnp.zeros((), jnp.int32))
    for i in range(9):
        want, jc = jt._ring_gqa_decode(zeroed, jcfg,
                                       jnp.asarray(x[:, i:i + 1]), jc)
    close(outs[-1], want, F32, "padded ring vs repro, padded rows zero")


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------


def test_mamba2_apply_and_decode_match_repro():
    """Three chunks of 16 through the SSD scan; then 12 decode steps (the
    f32 state and the f32 conv tail)."""
    jcfg, cfg = cfgs("mamba2-130m")
    params = jssm.mamba2_init(jax.random.PRNGKey(8), jcfg)
    p = tp(params)
    x = f32(np.random.default_rng(6), 2, 48, cfg.d_model)
    close(ssm.mamba2_apply(p, cfg, t(x)),
          jssm.mamba2_apply(params, jcfg, jnp.asarray(x)), F32, "mamba2")
    js = jssm.mamba2_state_init(jcfg, 2)
    st = convert.mamba2_state(*(np.asarray(a) for a in js), device="cpu")
    jdec = jax.jit(jssm.mamba2_decode, static_argnums=1)
    for i in range(12):
        want, js = jdec(params, jcfg, jnp.asarray(x[:, i:i + 1]), js)
        got, st = ssm.mamba2_decode(p, cfg, t(x[:, i:i + 1]), st)
        close(got, want, F32, f"mamba2 decode {i}")
    close(st.h, js.h, F32, "ssm state")
    close(st.conv, js.conv, F32, "conv tail")
    assert st.conv.dtype == torch.float32 and st.pos == 12
    with pytest.raises(AssertionError, match="chunk"):
        ssm.mamba2_apply(p, cfg, t(x[:, :40]))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 256])
def test_rglru_apply_and_decode_match_repro(chunk):
    jcfg, cfg = cfgs("recurrentgemma-2b")
    params = jrglru.rglru_init(jax.random.PRNGKey(9), jcfg)
    p = tp(params)
    x = f32(np.random.default_rng(7), 2, 32, cfg.d_model)
    close(rglru.rglru_apply(p, cfg, t(x), chunk=chunk),
          jrglru.rglru_apply(params, jcfg, jnp.asarray(x), chunk=chunk),
          F32, f"rglru chunk {chunk}")
    js = jrglru.rglru_state_init(jcfg, 2)
    st = convert.rglru_state(*(np.asarray(a) for a in js), device="cpu")
    jdec = jax.jit(jrglru.rglru_decode, static_argnums=1)
    for i in range(8):
        want, js = jdec(params, jcfg, jnp.asarray(x[:, i:i + 1]), js)
        got, st = rglru.rglru_decode(p, cfg, t(x[:, i:i + 1]), st)
        close(got, want, F32, f"rglru decode {i}")
    close(st.h, js.h, F32, "lru state")
    close(st.conv, js.conv, F32, "conv tail")


def test_lru_scan_composes_the_recurrence():
    """The chunked scan equals the plain loop h_t = a_t h_{t-1} + u_t from
    a non-zero h0, across chunk boundaries."""
    rng = np.random.default_rng(8)
    a = t(rng.uniform(0.2, 1.0, (2, 24, 3, 4)).astype(np.float32))
    u = t(f32(rng, 2, 24, 3, 4))
    h0 = t(f32(rng, 2, 3, 4))
    hs, last = rglru._lru_scan(u, a, h0, 8)
    h, want = h0, []
    for i in range(24):
        h = a[:, i] * h + u[:, i]
        want.append(h)
    close(hs, torch.stack(want, 1), F32, "scan")
    close(last, h, F32, "last")


# ---------------------------------------------------------------------------
# Frontend input
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-large"])
def test_forward_embeds_match_repro(arch):
    """forward(embeds=), a prefill of {"embeds"} and decode steps of
    {"embed"}, against repro on the same embeddings."""
    jcfg, cfg = cfgs(arch)
    params = jt.init_params(jax.random.PRNGKey(10), jcfg)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    e = stub_embeddings(torch.Generator().manual_seed(0), cfg, 2, 16,
                        device="cpu")
    assert e.shape == (2, 16, cfg.d_model) and e.dtype == torch.float32
    je = jnp.asarray(e.numpy())
    want = jt.forward(params, jcfg, embeds=je)
    close(transformer.forward(tparams, cfg, embeds=e), want, F32, "forward")
    close(make_prefill_step(cfg)(tparams, {"embeds": e}), want[:, -1], F32,
          "prefill")
    js = jt.decode_state_init(jcfg, 2, max_len=8)
    st = transformer.decode_state_init(cfg, 2, 8, device="cpu")
    step = make_decode_step(cfg)
    for i in range(4):
        jl, js = jt.decode_step(params, jcfg, js, None,
                                embed_in=je[:, i:i + 1])
        lg, st = step(tparams, st, {"embed": e[:, i:i + 1]})
        close(lg, jl, F32, f"embed decode {i}")


# ---------------------------------------------------------------------------
# generate's max_len rule, the launcher and the package exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,rff,grows", [
    ("qwen2-0.5b", False, True), ("deepseek-v2-lite-16b", False, True),
    ("qwen2-0.5b", True, False), ("mamba2-130m", False, False),
    ("recurrentgemma-2b", False, False)])
def test_generate_raises_past_max_len_only_where_the_cache_grows(arch, rff,
                                                                  grows):
    """A GQA KV cache and an MLA latent cache hold max_len positions:
    generate raises past them. The RFF and mamba2 states are fixed and the
    hybrid's ring wraps: there generate runs on, and the hybrid's tokens
    past its ring are repro's."""
    from repro.serve import generate as jax_generate
    from repro_torch.serve.serve_loop import cache_grows, generate

    jcfg, cfg = cfgs(arch, local_window=4)
    if rff:
        jcfg, cfg = (jt.with_rff_attention(jcfg),
                     transformer.with_rff_attention(cfg))
    assert cache_grows(cfg) == grows
    params = jt.init_params(jax.random.PRNGKey(11), jcfg)
    tparams = convert.lm_params(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 4))
    if grows:
        with pytest.raises(ValueError, match="max_len"):
            generate(tparams, cfg, t(prompt).long(), steps=6, max_len=6)
        return
    got = generate(tparams, cfg, t(prompt).long(), steps=6, max_len=6)
    assert got.shape == (2, 6)
    if arch == "recurrentgemma-2b":  # ring of min(4, 6) slots, wrapped
        want = jax_generate(params, jcfg, jnp.asarray(prompt, jnp.int32),
                            steps=6, max_len=6)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_launch_serve_takes_every_family(arch):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--arch", arch, "--tokens", "3",
         "--prompt-len", "2", "--batch", "2"],
        env=env, cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"arch={arch}" in proc.stdout and "sample:" in proc.stdout


def test_model_and_config_exports_are_repros():
    """repro_torch.models exports all of repro.models' names (lm_loss among
    them); repro_torch.configs all of repro.configs'."""
    import repro.configs as jconfigs
    import repro.models as jmodels
    import repro_torch.configs as tconfigs
    import repro_torch.models as tmodels

    assert set(tmodels.__all__) == set(jmodels.__all__)
    assert all(hasattr(tmodels, n) for n in tmodels.__all__)
    assert set(tconfigs.__all__) == set(jconfigs.__all__)
    assert all(hasattr(tconfigs, n) for n in tconfigs.__all__)
