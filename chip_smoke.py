#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and:

1. prints the card's name and power limit and the build seconds;
2. holds each KLMS-slice kernel (KLMS chunk, KLMS step, bank predict)
   against its plain PyTorch version on the card, at the serving shapes
   and at ragged ones, and checks the bitwise contracts (a chunk of 16
   equals 16 steps, a chunk at T=1 equals a step, a masked tick leaves
   theta unchanged, a tenant's chunk at B=1 equals its row of the B=1024
   launch);
3. drives the KLMS main path: a ``make_server("klms")`` bank of 1024
   tenants with a d=128, D=2048 random-feature map and chunk=16 takes a
   ragged stream, flushes, drains and serves single-tenant and (1024, 64)
   block reads at f32 and bf16, and a ``make_tick`` lockstep tier ticks the
   bank; the kernel server is compared with the same server run with
   ``mode="ref"`` on the card, and each kernel's launch count must rise;
4. holds both KRLS kernels (chunk, step) against their plain versions at
   the serving shape (B=1024, d=5, D=300, T=16) and at ragged ones (D up
   to 1024, and a P that is not symmetric), each on both of its routes
   (P's triangle resident in shared memory up to D = 335 at d = 5, where
   a step is the resident chunk kernel at T = 1; P streamed each tick at
   D = 400 and 1024), with the bitwise contracts on each route (a chunk of
   T equals T steps, T = 1 a step, the streaming step the routed step, P'
   exactly symmetric, masked ticks a no-op);
5. drives the KRLS main path: ``make_server("krls")`` at the paper's §6
   settings (d=5, D=300, sigma=5, lam=1e-4, beta=0.9995) with B=1024 and
   chunk=16, its reads and a ``make_tick("krls")`` tier, against the same
   server with ``mode="ref"`` and within the f32 error budget that a
   float64 run of the same stream measures;
6. times each kernel, its plain version and its bound at the serving
   shapes, the KRLS kernels' streaming routes where they are picked (the
   serving bank at D = 400), and the read kernel on its bf16 route, at
   the KRLS read shape (d = 5, D = 300) and at one tenant (B = 1, the
   policy tier's and the quarantine's reads);
7. holds the replay kernels (feature map, KLMS and KRLS chunk elements)
   against their plain versions at the replay shape (T=256, d=128,
   D=2048), the read-block shape of the feature map (65536 rows), the
   paper's d=5, D=300 and ragged shapes, the KLMS element (formed in
   closed form, not by the fold) against a float64 fold at the replay
   shape (within twice the f32 fold's distance) and in a stress case (d =
   5, D = 300, mu = 1.5), the KRLS element (one weighted Gram, not the
   fold) against a float64 fold at the paper's shape and at D = 2048
   (within twice the f32 fold's distance), with their exact contracts (a
   fully masked chunk is the identity element, two calls agree, a
   remainder chunk equals its live ticks alone, a chunk alone equals it
   among others, Phi equals Phi^T, every product tile gives the same
   bits) and a feature row's bits alone, in a 256-row and in a 65536-row
   call on every tile plan;
8. drives the KLMS lifecycle: ``make_server("klms", log_capacity=256)``
   at the KLMS serving configuration evicts four tenants (a history that
   overflows the ring, one of 201 ticks, one of a single tick, one with
   none), takes more arrivals while they are evicted and readmits them
   under rebuild_mode "blocked", "scan" and "sequential"; held against a
   never-evicted control server, ``rff_klms_run`` over each log, the same
   server with ``mode="ref"``, and bit for bit on untouched tenants; then
   reads and trains again;
9. drives the KRLS lifecycle the same way at the paper's section 6
   settings under "blocked" and "scan", held within the f32 error budget
   that the same server run in float64 measures, and bit for bit on
   untouched tenants;
10. times the replay kernels and readmission (wall time per mode and
    family, at D=2048 and D=300), the KRLS element at the paper's shape
    and at D = 2048; each element's bound is the smaller of the fold's and
    the closed form's operation counts;
11. holds the LM slice's kernels (RFF decode block, chunked linear
    attention, flash attention) against their plain versions at
    qwen2-0.5b's shapes (56 heads at B=4, dh=64, D=256, S=2048), at
    llama3-8b's head width (dh=dv=128), at padded shapes and, for linear
    attention, a long sequence (8 heads, S = 4096); the decode block for
    prf and trig, f32 and bf16, T = 1, the default block_t and block_t + 3
    (a remainder launch), and bit for bit, at every head, a block of T
    against T one-token launches; bit for bit, the first dv tile of both
    RFF kernels against a call on its columns alone, and two
    linear-attention launches; flash attention at f32 (the CUDA-core kernel)
    and bf16 (the tensor-core kernel), also at the config heads whose q/k
    and v widths differ or pass 128 ((192, 128), (96, 64), (256, 256)),
    each route's error reported;
12. serves qwen2-0.5b at full width with RFF attention, bf16, random
    weights from --seed: ``make_prefill_step`` at B=4, S=2048 (the linear
    attention kernel, once a layer) and ``generate`` of 32 greedy tokens
    after a 16-token prompt (the decode kernel, once a layer a token),
    held against ``kernel_mode="ref"`` and an f32 copy of the model;
13. prefills qwen2-0.5b as published (GQA) at B=4, S=2048 through the
    tensor-core flash kernel, against ``kernel_mode="ref"`` (the dense
    path) and the f32 copy, then generates a few tokens (no kernel on that
    path);
14. times kernels 9-11, their plain versions, their bounds and SDPA (flash
    on both routes; kernel 9 and its plain version by torch.profiler
    device time, since a one-token call's event time is the host's), the
    prefill and decode tokens per second of both models (the GQA prefill's
    profile must show the tensor-core flash kernel once a layer, the RFF
    prefill's both launches of the linear-attention kernel once a layer
    and no op of its plain version), and the
    decode state's bytes (the RFF state against the KV cache at 2048 and
    32768 tokens);
15. serves the remaining learners: ``make_server("nklms")`` at the KLMS
    serving configuration on the KLMS phase's ragged stream (writes
    through the generic chunk loop, f32 and bf16 reads through the read
    kernel) against ``mode="ref"`` and ``rff_klms_run(normalized=True)``
    over each of the busiest tenants' logs, then through the lifecycle
    of step 8 (readmits through the feature map and the KLMS element
    kernel); ``make_server("qklms")`` and ``make_server("ald")`` at the
    paper's example-2 settings (d = 5, sigma = 5, capacity 256; ALD at
    nu = 5e-3) with B = 1024 and chunk = 16 on model-(9) streams, each
    equal to ``run_stream`` on the same sequences bit for bit, a masked
    tick changing no bit and a sequential readmit within 1e-5 (relative)
    of a never-evicted control (whether it is bitwise is printed); one
    flush of each of the three families timed;
16. runs the paper's experiments (``repro_torch.paper.run_all``):
    figures 1-3 at ``EXPERIMENTS``' run counts (fig. 2b at repro's 3000
    samples), table 1 and table1_highdim, each RFF side through its chunk
    kernel and again with ``mode="ref"`` on the same realizations (tail
    MSEs within 1e-3, relative; every prior error of every run within
    1e-4 of the largest, RFF-KRLS's within the KRLS server's float64
    budget), printing each figure's tail MSEs, derived ratio
    and per-sample microseconds (QKLMS and ALD also as one CUDA graph of
    the generic loop: their device time without the launches); the phase
    must end within 120 s;
17. drives the feature families (``feature_families``): a qmc map (built
    on the card and bit for bit the CPU's) through step 3's KLMS main path
    at d = 128, D = 2048 and a gq map (non-uniform per-feature scales)
    through step 5's KRLS main path at the paper's section 6 settings, each
    with its launches checked; gq at d = 128 must raise (the tensor grid's
    cap); the taylor map (no trig form, D = C(10, 5) = 252 at d = 5, degree
    5) through make_server("klms") and ("krls"), reads and make_tick on
    the generic route: state on the card, no kernel launch, mode="ref"
    changing no bit, held against a float64 run (KLMS at SERVER_TOL, KRLS
    by the budget rule); then steps 8 and 9 under "blocked" alone with the
    qmc KLMS and the gq KRLS servers (kernels 6 and 7, 6 and 8);
18. runs the bank as a cache (``policy``): make_server("klms",
    policy=p, log_capacity=256, rebuild_mode="blocked") at the KLMS
    serving configuration, for p in lru, lfu and cost, on 16384 writes and
    one read of Q = 64 queries every 4 writes from a Zipf(0.9) stream over
    4096 tenants (zipf_bench's middle alpha and 1:4 ratio at the serving
    bank); held against the same server with rebuild_mode="sequential"
    (identical counters and resident map, resident rows and reads within
    REPLAY_REL) and, on a prefix of the stream, mode="ref" (the same
    decisions, SERVER_TOL); under lru, Server.resize 1024 -> 512 -> 1024
    keeps the surviving rows bit for bit; auto_resize (lfu) against
    mode="ref" on a short stream; make_server("krls", policy="lru") at the
    paper's section 6 settings on 4096 writes, within the float64 budget.
    Prints, per policy, the hit rate, the counters, write and read p50/p99
    from the server's registry and the install count and install ms
    (each install timed with a synchronize on each side);
19. runs the observability and recovery tier (``obs_recovery``): at the
    KLMS serving configuration (log_capacity=256, rebuild_mode="blocked")
    on step 3's ragged stream and at the KRLS section 6 one on step 5's, a
    ``trace=True, probe=True, recovery=True, wal=`` server equals the bare
    one in every leaf and read (f32 and bf16) bit for bit, raises no
    degradation event (its healthy stats printed), and
    ``kernel.launches{op=...}`` of ``obs.telemetry`` equals each wrapper's
    ``.launches`` rise; flush ms with and without the tap (medians of 20);
    ``check_read_contract`` at (1024, 64, 128) within 2e-2; the RFF rows of
    recovery_bench's repair grid at the serving banks plus drop_flush and
    clock_skew, each detect -> quarantine (reads equal ``predict_row`` of
    the last healthy row) -> the expected rung -> released, against a
    never-faulted control (a rebuilt row bit for bit the operator's
    readmit of the same log and, for KLMS and NKLMS, within REPLAY_REL of
    the trained row; a reset row the fresh row; resymmetrized reads within
    5e-2), with detect, warm and cold repair microseconds; kill at a flush
    (two cuts of phase 18's first 4096 KLMS writes, one of KRLS), restore
    and WAL replay bit for bit, with save and restore ms and bytes;
20. runs the distribution tier (``distribution``): four ranks spawned on
    the card in one gloo process group (CUDA tensors; NCCL refuses two
    ranks on one card; ``dist_smoke.py`` runs the same rank body under
    NCCL, one rank a card) run (a) sharded KRLS at
    tests/test_krls_sharded.py's shape (d = 5, D = 256, sigma = 5, lam =
    1e-2, 600 ticks) per tick and in blocks of 8 and 32, within 1e-5
    (blocks 5e-5) of the dense plain run, one all_reduce a tick and one a
    block, P gathered bitwise symmetric, a predict through kernel 3; (b)
    the README memory model's full width, D = 32768, 256 ticks at lam =
    1e-2 (within 1e-4 of dense) and 1e-4 (within twice the dense f32
    run's distance from a float64 dense run), with ms a tick, all_reduce
    ms a tick and peak bytes a rank against ``krls_shard_bytes``; (c)
    krls_shard_bench's grid, D in 256, 512, 1024 (d = 8), sharded against
    dense ms a tick; (d) diffusion KLMS at four nodes, the reference
    configuration (combine every tick, never, int8) and example 1's width
    (D = 1000, mu = 1.0, 5000 samples a node, combining every 10 ticks),
    each node's ticks between combines one kernel-1 call, held within 1e-4
    of a plain
    single-process run (the int8 run by its tail MSE); (e) each of the
    twelve deprecated serve names once, bit for bit its facade call. The
    dense and plain controls run after the ranks have exited. The last
    phase line gives the whole run's seconds.

The line before the last is ``{"kernels": [...]}`` (flash_attention,
krls_bank_chunk and krls_bank_step with a record per route under
"routes", bank_predict with
"bf16", "krls_read" and "one_tenant" records beside its f32 serving one, rff_features
with a "read_block" record, krls_chunk_elements with a "d2048" one); the
last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BANK, D_IN, D_FEAT, CHUNK, Q = 1024, 128, 2048, 16, 64
SIGMA = float(np.sqrt(D_IN))  # kernel bandwidth matched to |x| ~ sqrt(d)
MU = 0.5
F32_TOL = 1e-4  # FMA contraction, summation order and cosf vs torch.cos
BF16_TOL = 1e-3  # plus one-ulp bf16 flips of z at rounding boundaries
SERVER_TOL = 1e-4  # the recursion carries per-tick f32 differences
RAGGED = [(7, 5, 300), (1, 1, 17), (33, 128, 129)]  # (B, d, D)
# KRLS serving: the paper's section 6 settings (src/repro/core/krls.py:122,
# benchmarks/paper.py:145) over the same bank, chunk and read block.
K_D_IN, K_D_FEAT, K_SIGMA, K_LAM, K_BETA = 5, 300, 5.0, 1e-4, 0.9995
K_RAGGED = [(3, 4, 17, 5), (5, 128, 129, 3), (2, 5, 1024, 4)]  # (B, d, D, T)
# The chunk kernel's two routes: P resident in shared memory (D <= 335 at
# d = 5, the serving shape among them) or streamed each tick (wider D, as
# at D = 400 here and D = 1024 above).
KRLS_ROUTES = ("resident", "streaming")
K_STREAMING = [(8, 5, 400, 6)]  # (B, d, D, T)
K_D_WIDE = 400  # the streaming route's timing width (serving B, T and d)
# P is compared normwise, as a share of each tenant's max |P|: its entries
# span 1/lam = 1e4 down to O(1) remainders of cancellation.
P_TOL = 1e-4
# Over a served stream at lam = 1e-4 f32 itself is the limit (the
# recursion forms O(1) values as differences of O(1e4) ones): the kernel
# server must be within BUDGET times the plain server's own f32 error of a
# float64 run of the same stream, plus BUDGET_FLOOR.
BUDGET, BUDGET_FLOOR = 2.0, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores

# Replay (evict -> log -> readmit): the ring size, and the features held
# relative to max|s| (z is at most s in size): 1e-5 at f32, the 2e-2 read
# contract for bf16. Readmitted KLMS tenants are held to a never-evicted
# control at 5e-5 relative in norm (tests/test_eviction.py).
LOG_CAP = 256
FEAT_TOL, FEAT_BF16_TOL = 1e-5, 2e-2
REPLAY_REL = 5e-5

REPLACES = {
    "klms_bank_chunk": "src/repro/kernels/rff_klms_step.py:211",
    "klms_bank_step": "src/repro/kernels/rff_klms_step.py:80",
    "bank_predict": "src/repro/kernels/rff_predict.py:84",
    "krls_bank_chunk": "src/repro/kernels/rff_krls_step.py:262",
    "krls_bank_step": "src/repro/kernels/rff_krls_step.py:104",
    "rff_features": "src/repro/kernels/rff_features.py:76",
    "klms_chunk_elements": "src/repro/kernels/rff_scan.py:115",
    "krls_chunk_elements": "src/repro/kernels/rff_scan.py:241",
}
SOURCES = {
    "klms_bank_chunk": "src/repro_torch/csrc/klms_bank.cu",
    "klms_bank_step": "src/repro_torch/csrc/klms_bank.cu",
    "bank_predict": "src/repro_torch/csrc/bank_predict.cu",
    "krls_bank_chunk": "src/repro_torch/csrc/krls_bank.cu",
    "krls_bank_step": "src/repro_torch/csrc/krls_bank.cu",
    "rff_features": "src/repro_torch/csrc/rff_features.cu",
    "klms_chunk_elements": "src/repro_torch/csrc/rff_scan.cu",
    "krls_chunk_elements": "src/repro_torch/csrc/rff_scan.cu",
}
TOLERANCE = {"klms_bank_chunk": F32_TOL, "klms_bank_step": F32_TOL,
             "bank_predict": BF16_TOL, "krls_bank_chunk": F32_TOL,
             "krls_bank_step": F32_TOL, "rff_features": FEAT_TOL,
             "klms_chunk_elements": F32_TOL, "krls_chunk_elements": F32_TOL}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def hold(name: str, got, want, tol: float) -> float:
    """Fail unless ``got`` agrees with ``want`` within ``tol`` (abs + rel)."""
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        bad = (g - w).abs() > tol + tol * w.abs()
        check(not bool(bad.any()), f"{name}: {int(bad.sum())} values off by up "
              f"to {max_err(g, w):.3g} (tol {tol})")
    return max(max_err(g, w) for g, w in zip(got, want))


def inputs(rng, bank, tlen, d, dfeat, device, mask_p=0.3):
    """Kernel inputs of one shape, made from numpy, on the card."""
    f32 = np.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, f32)).to(device)

    from repro_torch.kernels.ref import default_scale

    return dict(
        theta=t(0.3 * rng.normal(size=(bank, dfeat))),
        xs=t(rng.normal(size=(bank, tlen, d))),
        ys=t(rng.normal(size=(bank, tlen))),
        mask=t(rng.random((bank, tlen)) > mask_p),
        w=t(rng.normal(size=(d, dfeat)) / np.sqrt(d)),
        b=t(rng.uniform(0, 2 * np.pi, size=dfeat)),
        s=default_scale(dfeat, device=device),
        mu=t(rng.uniform(0.05, 1.0, size=bank)),
    )


def phase_kernels(rng, device) -> dict:
    """Every kernel against its plain version, and the bitwise contracts."""
    from repro_torch.kernels import ops

    errs = {"klms_bank_chunk": 0.0, "klms_bank_step": 0.0, "bank_predict": 0.0}
    shapes = [(BANK, D_IN, D_FEAT)] + RAGGED
    for bank, d, dfeat in shapes:
        a = inputs(rng, bank, CHUNK if bank == BANK else 5, d, dfeat, device)
        args = (a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"],
                a["mask"], a["s"])
        e = hold(f"klms_bank_chunk {bank, d, dfeat}",
                 ops.rff_klms_bank_chunk(*args, mode="cuda"),
                 ops.rff_klms_bank_chunk(*args, mode="ref"), F32_TOL)
        errs["klms_bank_chunk"] = max(errs["klms_bank_chunk"], e)
        x0, y0 = a["xs"][:, 0].contiguous(), a["ys"][:, 0].contiguous()
        sargs = (a["theta"], x0, y0, a["w"], a["b"], a["mu"], a["s"])
        e = hold(f"klms_bank_step {bank, d, dfeat}",
                 ops.rff_klms_bank_step(*sargs, mode="cuda"),
                 ops.rff_klms_bank_step(*sargs, mode="ref"), F32_TOL)
        errs["klms_bank_step"] = max(errs["klms_bank_step"], e)
        qlen = Q if bank == BANK else 13
        xq = torch.from_numpy(
            rng.normal(size=(bank, qlen, d)).astype(np.float32)).to(device)
        for precision, tol in ((None, F32_TOL), ("bf16", BF16_TOL)):
            pargs = (a["theta"], xq, a["w"], a["b"], a["s"])
            e = hold(f"bank_predict {precision} {bank, d, dfeat}",
                     [ops.rff_bank_predict(*pargs, mode="cuda",
                                           precision=precision)],
                     [ops.rff_bank_predict(*pargs, mode="ref",
                                           precision=precision)], tol)
            errs["bank_predict"] = max(errs["bank_predict"], e)

    # Bitwise contracts at the serving shape.
    a = inputs(rng, BANK, CHUNK, D_IN, D_FEAT, device)
    common = (a["w"], a["b"], a["mu"])
    theta_c, pred_c, err_c = ops.rff_klms_bank_chunk(
        a["theta"], a["xs"], a["ys"], *common, None, a["s"], mode="cuda")
    theta = a["theta"]
    for t in range(CHUNK):
        theta, pred, err = ops.rff_klms_bank_step(
            theta, a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous(),
            *common, a["s"], mode="cuda")
        check(torch.equal(pred, pred_c[:, t]) and torch.equal(err, err_c[:, t]),
              f"chunk of {CHUNK} vs steps: tick {t} outputs differ")
    check(torch.equal(theta, theta_c), f"chunk of {CHUNK} vs steps: theta differs")
    one = ops.rff_klms_bank_chunk(
        a["theta"], a["xs"][:, :1].contiguous(), a["ys"][:, :1].contiguous(),
        *common, None, a["s"], mode="cuda")
    first = ops.rff_klms_bank_step(
        a["theta"], a["xs"][:, 0].contiguous(), a["ys"][:, 0].contiguous(),
        *common, a["s"], mode="cuda")
    check(torch.equal(one[0], first[0]) and torch.equal(one[1][:, 0], first[1]),
          "chunk at T=1 vs step differ")
    zeros = torch.zeros_like(a["ys"])
    masked = ops.rff_klms_bank_chunk(
        a["theta"], a["xs"], a["ys"], *common, zeros, a["s"], mode="cuda")
    check(torch.equal(masked[0], a["theta"]), "masked ticks changed theta")
    check(masked[0].data_ptr() != a["theta"].data_ptr(), "theta' aliases theta")
    prior = ops.rff_bank_predict(a["theta"], a["xs"], a["w"], a["b"], a["s"],
                                 mode="ref")
    hold("masked ticks emit the prior prediction", [masked[1]], [prior], F32_TOL)
    # A tenant's bits do not depend on the bank it shares a launch with.
    full = ops.rff_klms_bank_chunk(a["theta"], a["xs"], a["ys"], a["w"], a["b"],
                                   a["mu"], a["mask"], a["s"], mode="cuda")
    rows = (0, BANK // 2 + 5, BANK - 1)
    for row in rows:
        sl = slice(row, row + 1)
        one = ops.rff_klms_bank_chunk(
            a["theta"][sl], a["xs"][sl], a["ys"][sl], a["w"], a["b"],
            a["mu"][sl], a["mask"][sl], a["s"], mode="cuda")
        check(all(torch.equal(g[0], w[row]) for g, w in zip(one, full)),
              f"tenant {row}: a chunk at B = 1 differs from its row of the "
              f"B = {BANK} launch")
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "shapes": shapes, "max_abs_err": errs,
          "tolerance": {"f32": F32_TOL, "bf16_predict": BF16_TOL},
          "bitwise": {"chunk16_eq_16_steps": True, "chunk1_eq_step": True,
                      "masked_tick_noop": True,
                      f"b1_eq_row_of_b{BANK}": list(rows)}})
    return errs


def ragged_stream(rng, rounds: int, d: int):
    """Per round, per tenant, a Poisson count of arrivals (Zipf-like
    rates, 10% of tenants idle) of a per-tenant target: an offset the
    filter learns within a few ticks plus a smooth ridge function of the
    d inputs."""
    rates = 24.0 / (1.0 + np.arange(BANK)) ** 0.5
    rates = rng.permutation(rates)
    rates[rng.random(BANK) < 0.1] = 0.0
    dirs = rng.normal(size=(BANK, d)) / np.sqrt(d)
    for _ in range(rounds):
        counts = rng.poisson(rates)
        tenants = np.repeat(np.arange(BANK), counts)
        rng.shuffle(tenants)
        xs = rng.normal(size=(len(tenants), d)).astype(np.float32)
        proj = np.einsum("nd,nd->n", xs, dirs[tenants])
        ys = 1.0 + 0.5 * np.sin(proj) + 0.05 * rng.normal(size=len(tenants))
        yield tenants, xs, ys.astype(np.float32)


# Per-route launches of the kernels with two routes (flash_attention,
# krls_bank_chunk), summed over every main-path run as path_launches reads
# them.
ROUTE_LAUNCHES: dict = {}


def reset_launches(kernels) -> None:
    for k in kernels.values():
        k.launches = 0
        for route in getattr(k, "route_launches", {}):
            k.route_launches[route] = 0


def path_launches(kernels, names) -> dict:
    """The launch counts of a path's kernels; each must have launched.
    Per-route counts are added to ROUTE_LAUNCHES."""
    launches = {name: kernels[name].launches for name in names}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        for route, m in getattr(kernels[name], "route_launches", {}).items():
            seen = ROUTE_LAUNCHES.setdefault(name, {})
            seen[route] = seen.get(route, 0) + m
    return launches


def family_map(family, seed, d, dfeat, sigma, device):
    """A feature map of ``family`` on the card (the Monte-Carlo families
    drawn from ``seed``)."""
    from repro_torch.features import make_feature_map

    return make_feature_map(family, d, dfeat, sigma,
                            generator=torch.Generator().manual_seed(seed),
                            device=device)


def phase_server(seed, device, kernels, family="rff") -> dict:
    """The KLMS main path: make_server("klms") writes and reads,
    make_tick (the paper's rff map, or another trig family)."""
    from repro_torch.serve import make_server, make_tick

    fm = family_map(family, seed, D_IN, D_FEAT, SIGMA, device)
    srv = make_server("klms", feature_map=fm, bank=BANK, chunk=CHUNK, mu=MU,
                      device=device)
    ref_srv = make_server("klms", feature_map=fm, bank=BANK, chunk=CHUNK,
                          mu=MU, device=device, mode="ref")
    rng = np.random.default_rng(seed + 1)
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, D_IN)).astype(np.float32)).to(device)
    tick = make_tick("klms", fm, mu=MU)
    ref_tick = make_tick("klms", fm, mu=MU, mode="ref")
    tick_x = torch.from_numpy(
        rng.normal(size=(4, BANK, D_IN)).astype(np.float32)).to(device)
    tick_y = torch.sin(tick_x[..., 0])

    reset_launches(kernels)
    t0 = time.perf_counter()
    mse, flushes, submits = [], 0, 0
    for rnd, (tenants, xs, ys) in enumerate(ragged_stream(rng, 6, D_IN)):
        for s in (srv, ref_srv):
            for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                s.submit(t, x, y)
        submits += len(tenants)
        res = srv.drain() if rnd % 2 else srv.flush()
        ref_res = ref_srv.drain() if rnd % 2 else ref_srv.flush()
        check(sorted(res) == sorted(ref_res), "served tenants differ")
        got = np.array([e for r in res.values() for _, e in r])
        want = np.array([e for r in ref_res.values() for _, e in r])
        check(np.allclose(got, want, atol=SERVER_TOL, rtol=SERVER_TOL),
              f"flush errors differ by {np.abs(got - want).max():.3g}")
        mse.append(float(np.mean(got ** 2)))
        flushes = srv.queue.flushes
    reads = {}
    for prec in (None, "bf16"):
        for s in (srv, ref_srv):
            s.snapshot_server.precision = prec
        blk = srv.predict_block(xq)
        reads[prec] = blk
        hold(f"predict_block {prec}", [blk], [ref_srv.predict_block(xq)],
             SERVER_TOL if prec is None else BF16_TOL)
        for tenant in (0, 1, BANK - 1):
            hold(f"predict tenant {tenant} {prec}",
                 [srv.predict(tenant, xq[tenant])],
                 [ref_srv.predict(tenant, xq[tenant])],
                 SERVER_TOL if prec is None else BF16_TOL)
    state, ref_state = srv.queue.state, ref_srv.queue.state
    for t in range(tick_x.shape[0]):
        state, out = tick(state, tick_x[t], tick_y[t])
        ref_state, ref_out = ref_tick(ref_state, tick_x[t], tick_y[t])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(
        kernels, ("klms_bank_chunk", "klms_bank_step", "bank_predict"))

    check(flushes >= 6, f"only {flushes} flushes")
    hold("final theta", [srv.snapshot.state.theta], [ref_srv.snapshot.state.theta],
         SERVER_TOL)
    hold("make_tick theta", [state.theta], [ref_state.theta], SERVER_TOL)
    check(torch.equal(srv.snapshot.state.step, ref_srv.snapshot.state.step),
          "tick counts differ")
    check(mse[-1] < mse[0], f"prior MSE did not fall: {mse}")
    bf16_gap = max_err(reads["bf16"], reads[None])
    check(0 < bf16_gap < 2e-2, f"bf16 read contract: gap {bf16_gap}")
    emit({"phase": "server", "family": family, "bank": BANK, "d": D_IN,
          "D": D_FEAT, "chunk": CHUNK, "Q": Q, "submits": submits,
          "flushes": flushes,
          "prior_mse_per_round": mse, "bf16_vs_f32_read_gap": bf16_gap,
          "staleness": srv.staleness, "launches": launches,
          "seconds": seconds})
    return launches


def p_rel(got, want) -> float:
    """max |got - want| / max |want| per tenant, then the max over tenants."""
    g, w = got.flatten(1).double(), want.flatten(1).double()
    return float(((g - w).abs().amax(1) / w.abs().amax(1)).max())


def normwise(got, want) -> float:
    """max |got - want| / (1 + max |want|) per tenant, then the max."""
    g, w = got.flatten(1).double(), want.flatten(1).double()
    return float(((g - w).abs().amax(1) / (1 + w.abs().amax(1))).max())


def hold_krls(name: str, got, want) -> tuple[float, float, float]:
    """(theta', P', preds, errs) of a KRLS kernel against its plain version:
    theta', preds and errs within F32_TOL (abs + rel), P' within P_TOL of
    each tenant's max |P|. Returns the largest absolute difference of
    theta', preds and errs, the largest share of their tolerance it used,
    and the largest relative difference of P'."""
    pairs = [(got[k], want[k]) for k in (0, 2, 3)]
    err = hold(name, *zip(*pairs), F32_TOL)
    share = max(float(((g - w).abs() / (F32_TOL * (1 + w.abs()))).max())
                for g, w in pairs)
    check(got[1].shape == want[1].shape, f"{name}: P shape")
    check(bool(torch.isfinite(got[1]).all()), f"{name}: non-finite P")
    rel = p_rel(got[1], want[1])
    check(rel <= P_TOL, f"{name}: P off by {rel:.3g} of max|P| (tol {P_TOL})")
    return err, share, rel


def krls_inputs(rng, bank, tlen, d, dfeat, device, pmat="spd"):
    """KRLS kernel inputs: the KLMS ones plus per-tenant beta in [0.99, 1)
    and P = I / lam (``"eye"``, a fresh tenant), 10 I + A A^T (``"spd"``, as
    tests/test_chunked.py) or that plus a non-symmetric part (``"asym"``)."""
    a = inputs(rng, bank, tlen, d, dfeat, device)
    a["beta"] = torch.from_numpy(
        rng.uniform(0.99, 1.0, size=bank).astype(np.float32)).to(device)
    eye = torch.eye(dfeat, device=device)
    if pmat == "eye":
        a["pmat"] = (eye.expand(bank, dfeat, dfeat) / K_LAM).contiguous()
        return a

    def normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device)

    m = 0.1 * normal(bank, dfeat, dfeat)
    p = 10.0 * eye + torch.bmm(m, m.transpose(1, 2))
    if pmat == "asym":
        p = p + 0.5 * normal(bank, dfeat, dfeat)
    a["pmat"] = p.contiguous()
    return a


def krls_contracts(a, route) -> None:
    """The bitwise contracts of the chunk route that a's shape picks
    (``route``, checked on every launch): a chunk of T equals T step
    launches (the step on the same route) and T = 1 one step, a chain of
    streaming step launches equals the routed steps at every tick, P' of a
    symmetric P is exactly symmetric, masked ticks leave theta and P bit for bit in fresh tensors and emit
    the prior prediction."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_krls_step import (
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    common = (a["w"], a["b"], a["beta"])
    tlen = a["xs"].shape[1]
    tag = f"krls {route} {tuple(a['pmat'].shape)}"
    counts = rff_krls_bank_chunk_cuda.route_launches

    def chunk_of(*args):
        before = counts[route]
        out = rff_krls_bank_chunk_cuda(*args)
        check(counts[route] == before + 1, f"{tag}: launched another route")
        return out

    chunk = chunk_of(a["theta"], a["pmat"], a["xs"], a["ys"], *common, None,
                     a["s"])
    check(torch.equal(chunk[1], chunk[1].transpose(1, 2)),
          f"{tag}: P' of a symmetric P is not exactly symmetric")
    theta, pmat = a["theta"], a["pmat"]
    stheta, spmat = theta, pmat
    for t in range(tlen):
        x_t, y_t = a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous()
        theta, pmat, pred, err = ops.rff_krls_bank_step(
            theta, pmat, x_t, y_t, *common, a["s"], mode="cuda")
        check(torch.equal(pred, chunk[2][:, t]) and torch.equal(err, chunk[3][:, t]),
              f"{tag}: chunk of {tlen} vs steps: tick {t} outputs differ")
        # The step's routes: a chain of the streaming step kernel, which
        # the wider D take, equals the routed steps bit for bit.
        streamed = rff_krls_bank_step_cuda(stheta, spmat, x_t, y_t, *common,
                                           a["s"], _route="streaming")
        check(all(torch.equal(u, v) for u, v in
                  zip(streamed, (theta, pmat, pred, err))),
              f"{tag}: the streaming step vs the routed step: tick {t} differs")
        stheta, spmat = streamed[0], streamed[1]
        del streamed
        if t == 0:
            one = chunk_of(a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
                           a["ys"][:, :1].contiguous(), *common, None, a["s"])
            check(all(torch.equal(u, v) for u, v in
                      zip(one, (theta, pmat, pred[:, None], err[:, None]))),
                  f"{tag}: chunk at T=1 vs step differ")
    check(torch.equal(theta, chunk[0]) and torch.equal(pmat, chunk[1]),
          f"{tag}: chunk of {tlen} vs steps: theta or P differs")
    del chunk, theta, pmat, one, stheta, spmat
    masked = chunk_of(a["theta"], a["pmat"], a["xs"], a["ys"], *common,
                      torch.zeros_like(a["ys"]), a["s"])
    check(torch.equal(masked[0], a["theta"]) and torch.equal(masked[1], a["pmat"]),
          f"{tag}: masked ticks changed theta or P")
    check(masked[0].data_ptr() != a["theta"].data_ptr()
          and masked[1].data_ptr() != a["pmat"].data_ptr(),
          f"{tag}: theta' or P' aliases its input")
    prior = ops.rff_bank_predict(a["theta"], a["xs"], a["w"], a["b"], a["s"],
                                 mode="ref")
    hold(f"{tag}: masked ticks emit the prior prediction", [masked[2]],
         [prior], F32_TOL)


def phase_krls_kernels(rng, device) -> tuple[dict, dict, dict]:
    """Both KRLS kernels against their plain versions, each on both of its
    routes (P resident in shared memory up to D = 335 at d = 5: the chunk
    kernel, at T = 1 for a step; P streamed beyond: the chunk and step
    kernels of the streaming design), and the bitwise contracts of both
    routes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_krls_step import krls_chunk_route

    names = ("krls_bank_chunk", "krls_bank_step")
    errs, shares, rels = (dict.fromkeys(names, 0.0) for _ in range(3))
    by_route = {name: {r: {"max_abs_err": 0.0, "p_rel_err": 0.0, "cases": []}
                       for r in KRLS_ROUTES} for name in names}
    cases = [(BANK, K_D_IN, K_D_FEAT, CHUNK, "eye"),
             (BANK, K_D_IN, K_D_FEAT, CHUNK, "spd")]
    cases += [(*shape, "spd") for shape in K_RAGGED] + [(4, 5, 70, 6, "asym")]
    cases += [(*shape, kind) for shape in K_STREAMING for kind in ("spd", "asym")]
    for bank, d, dfeat, tlen, kind in cases:
        a = krls_inputs(rng, bank, tlen, d, dfeat, device, kind)
        args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
                a["beta"], a["mask"], a["s"])
        sargs = (a["theta"], a["pmat"], a["xs"][:, 0].contiguous(),
                 a["ys"][:, 0].contiguous(), a["w"], a["b"], a["beta"], a["s"])
        route = krls_chunk_route(dfeat, d)
        for name, op, xargs in (("krls_bank_chunk", ops.rff_krls_bank_chunk, args),
                                ("krls_bank_step", ops.rff_krls_bank_step, sargs)):
            e, f, r = hold_krls(f"{name} {bank, d, dfeat, tlen} P={kind}",
                                op(*xargs, mode="cuda"),
                                op(*xargs, mode="ref"))
            errs[name] = max(errs[name], e)
            shares[name] = max(shares[name], f)
            rels[name] = max(rels[name], r)
            rec = by_route[name][route]  # the step routes as the chunk
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["p_rel_err"] = max(rec["p_rel_err"], r)
            rec["cases"].append([bank, d, dfeat, tlen, kind])
        del a, args, sargs

    krls_contracts(krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_FEAT, device,
                               "spd"), "resident")
    for bank, d, dfeat, tlen in K_STREAMING:
        krls_contracts(krls_inputs(rng, bank, tlen, d, dfeat, device, "spd"),
                       "streaming")
    torch.cuda.synchronize()
    emit({"phase": "krls_kernels_vs_plain",
          "cases": [list(c) for c in cases], "max_abs_err": errs,
          "max_share_of_tolerance": shares, "p_rel_err": rels,
          "routes": by_route,
          "tolerance": {"theta_pred_err": F32_TOL, "p_of_max_abs_p": P_TOL},
          "bitwise_on_each_route": {"chunk_eq_steps": True,
                                    "chunk1_eq_step": True,
                                    "streaming_step_eq_routed_step": True,
                                    "masked_tick_noop_fresh_outputs": True,
                                    "p_out_exactly_symmetric": True}})
    return errs, rels, by_route


def within_budget(name: str, got, plain, exact, dist) -> dict:
    """The kernel server's distance from the float64 run must be within
    BUDGET times the plain server's own f32 distance, plus BUDGET_FLOOR;
    the kernel-vs-plain distance then within BUDGET + 1 times."""
    eps = dist(plain, exact)
    kernel, vs_plain = dist(got, exact), dist(got, plain)
    check(kernel <= BUDGET * eps + BUDGET_FLOOR,
          f"krls server {name}: kernel {kernel:.3g} from float64, plain "
          f"{eps:.3g} (budget x{BUDGET})")
    check(vs_plain <= (BUDGET + 1) * eps + BUDGET_FLOOR,
          f"krls server {name}: kernel vs plain {vs_plain:.3g}, plain "
          f"{eps:.3g} from float64")
    return {"kernel_vs_f64": kernel, "plain_vs_f64": eps,
            "kernel_vs_plain": vs_plain}


def f64_map(fm):
    """The same feature map in float64, its f32 parameters widened (for
    the float64 servers; taylor's integer exponents stay as they are)."""
    return dataclasses.replace(fm, params=type(fm.params)(*(
        t.double() if t.is_floating_point() else t for t in fm.params)))


def phase_krls_server(seed, device, kernels, family="rff") -> dict:
    """The KRLS main path: make_server("krls") writes and reads,
    make_tick("krls"); held against mode="ref" and a float64 run (the
    paper's rff map, or another trig family)."""
    from repro_torch.serve import make_server, make_tick

    fm = family_map(family, seed, K_D_IN, K_D_FEAT, K_SIGMA, device)
    fm64 = f64_map(fm)
    hp = dict(bank=BANK, chunk=CHUNK, lam=K_LAM, beta=K_BETA, device=device)
    servers = (make_server("krls", feature_map=fm, **hp),
               make_server("krls", feature_map=fm, mode="ref", **hp),
               make_server("krls", feature_map=fm64, mode="ref", **hp))
    ticks = [make_tick("krls", f, beta=K_BETA, mode=m)
             for f, m in ((fm, "auto"), (fm, "ref"), (fm64, "ref"))]
    rng = np.random.default_rng(seed + 2)
    xq = rng.normal(size=(BANK, Q, K_D_IN)).astype(np.float32)
    tick_x = rng.normal(size=(4, BANK, K_D_IN)).astype(np.float32)
    tick_y = np.sin(tick_x[..., 0]).astype(np.float32)

    reset_launches(kernels)
    t0 = time.perf_counter()
    errs, mse, submits = [[] for _ in servers], [], 0
    for rnd, (tenants, xs, ys) in enumerate(ragged_stream(rng, 6, K_D_IN)):
        for srv in servers:
            for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                srv.submit(t, x, y)
        submits += len(tenants)
        res = [srv.drain() if rnd % 2 else srv.flush() for srv in servers]
        check(all(sorted(r) == sorted(res[0]) for r in res),
              "krls servers served different tenants")
        for out, r in zip(errs, res):
            out.append(np.array([e for t in sorted(r) for _, e in r[t]]))
        mse.append(float(np.mean(errs[0][-1] ** 2)))
    blocks = [srv.predict_block(xq) for srv in servers]
    singles = [torch.stack([srv.predict(t, xq[t]) for t in (0, 1, BANK - 1)])
               for srv in servers]
    states = [srv.queue.state for srv in servers]
    for t in range(tick_x.shape[0]):
        for i, (tick, st) in enumerate(zip(ticks, states)):
            dt = st.theta.dtype
            states[i], _ = tick(st, torch.from_numpy(tick_x[t]).to(device, dt),
                                torch.from_numpy(tick_y[t]).to(device, dt))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(
        kernels, ("krls_bank_chunk", "krls_bank_step", "bank_predict"))
    routes = dict(kernels["krls_bank_chunk"].route_launches)
    check(routes["resident"] == launches["krls_bank_chunk"],
          f"krls flushes at D = {K_D_FEAT} did not all keep P resident: {routes}")
    step_routes = dict(kernels["krls_bank_step"].route_launches)
    check(step_routes["resident"] == launches["krls_bank_step"],
          f"krls ticks at D = {K_D_FEAT} did not all keep P resident: "
          f"{step_routes}")

    srv = servers[0]
    flushes = srv.queue.flushes
    check(flushes >= 6, f"only {flushes} krls flushes")
    check(all(torch.equal(s.snapshot.state.step, srv.snapshot.state.step)
              for s in servers), "krls tick counts differ")
    check(mse[-1] < mse[0], f"krls prior MSE did not fall: {mse}")
    snaps = [s.snapshot.state for s in servers]
    prior = [torch.from_numpy(np.concatenate(e))[None] for e in errs]
    budget = {
        "prior_errors": within_budget("prior errors", *prior, normwise),
        "theta": within_budget("theta", *[s.theta for s in snaps], normwise),
        "P": within_budget("P", *[s.pmat for s in snaps], p_rel),
        "predict_block": within_budget("predict_block", *blocks, normwise),
        "predict": within_budget("predict", *singles, normwise),
        "tick_theta": within_budget("make_tick theta",
                                    *[s.theta for s in states], normwise),
        "tick_P": within_budget("make_tick P", *[s.pmat for s in states],
                                p_rel),
    }
    for got, want in ((snaps[0].theta, snaps[1].theta), (blocks[0], blocks[1])):
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              "krls server output not finite or of the wrong shape")
    pmat = srv.snapshot.state.pmat
    emit({"phase": "krls_server", "family": family, "bank": BANK,
          "d": K_D_IN, "D": K_D_FEAT,
          "sigma": K_SIGMA, "lam": K_LAM, "beta": K_BETA, "chunk": CHUNK,
          "Q": Q, "submits": submits, "flushes": flushes,
          "prior_mse_per_round": mse, "staleness": srv.staleness,
          "launches": launches, "chunk_route_launches": routes,
          "step_route_launches": step_routes,
          "seconds": seconds,
          "p_device_bytes": pmat.numel() * pmat.element_size(),
          "budget": {"factor": BUDGET, "floor": BUDGET_FLOOR, **budget}})
    return launches


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def timed_case(fn, nbytes, nops, plain_reps: int = 20) -> dict:
    """``fn(mode)`` timed as plain, kernel, kernel, plain (two readings
    each, within one call), with its bound."""
    plain = [time_ms(lambda: fn("ref"), plain_reps)]
    kern = [time_ms(lambda: fn("cuda")), time_ms(lambda: fn("cuda"))]
    plain.append(time_ms(lambda: fn("ref"), plain_reps))
    bound, bound_by = bound_ms(nbytes, nops)
    return dict(ms=min(kern), plain_ms=min(plain), bound_ms=bound,
                bound_by=bound_by, bytes=nbytes, ops=nops, ms_runs=kern,
                plain_ms_runs=plain)


def krls_cost(dfeat: int, rows: int) -> tuple[int, int]:
    """Bytes and operations of ``rows`` live KRLS ticks a tenant over the
    serving bank at width ``dfeat`` (d = K_D_IN): theta and P in and out,
    W, b, s, each tick's x, y and outputs, beta; per tick 2 d D for the
    features, 7 D^2 for P z and the downdate, 12 D for the rest."""
    shared = 4 * (K_D_IN * dfeat + 2 * dfeat)
    state = 4 * 2 * BANK * (dfeat ** 2 + dfeat)
    tick = 2 * K_D_IN * dfeat + 7 * dfeat ** 2 + 12 * dfeat
    return (shared + state + 4 * (BANK * rows * (K_D_IN + 3) + BANK),
            BANK * rows * tick)


def krls_chunk_case(k) -> tuple:
    """``krls_bank_chunk`` over k's bank (every tick live), with its cost."""
    from repro_torch.kernels import ops

    return (lambda m: ops.rff_krls_bank_chunk(
                k["theta"], k["pmat"], k["xs"], k["ys"], k["w"], k["b"],
                k["beta"], None, k["s"], mode=m),
            *krls_cost(k["pmat"].shape[-1], k["xs"].shape[1]))


def phase_times(rng, device) -> dict:
    """Kernel, plain version and bound at the serving shapes.

    Operations count the projection's 2 d D multiply-adds per row and, per
    feature, bias add, cos (as one operation), scale, the theta . z
    multiply-add and, for KLMS, the update's multiply-add: a lower bound,
    since a cosf takes tens of instructions. The read kernel is also timed
    at the KRLS read shape (d = 5, D = 300) and on its bf16 route, whose
    bound is the products at the bf16 tensor-core rate plus 5 D operations
    a row (bias, cos, scale, the theta . z multiply-add) at the f32 rate. A KRLS tick adds, per tenant,
    2 D^2 for P z, 5 D^2 for the downdate and its symmetrization, and 5 D
    for z . pz, the gain and the theta update (every tick of the timed
    chunk is live). Bytes count each input read once and each output
    written once: for KRLS, P in and P' out dominate. Both KRLS kernels
    are timed on their resident route at D = 300 and their streaming route
    at D = K_D_WIDE.
    """
    from repro_torch.kernels import ops

    a = inputs(rng, BANK, CHUNK, D_IN, D_FEAT, device)
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, D_IN)).astype(np.float32)).to(device)
    x0, y0 = a["xs"][:, 0].contiguous(), a["ys"][:, 0].contiguous()
    shared = 4 * (D_IN * D_FEAT + 2 * D_FEAT)  # W, b, s
    rows_chunk, rows_step, rows_pred = BANK * CHUNK, BANK, BANK * Q
    cases = {
        "klms_bank_chunk": (
            lambda m: ops.rff_klms_bank_chunk(
                a["theta"], a["xs"], a["ys"], a["w"], a["b"], a["mu"],
                a["mask"], a["s"], mode=m),
            shared + 4 * (2 * BANK * D_FEAT + BANK * CHUNK * (D_IN + 4) + BANK),
            rows_chunk * (2 * D_IN * D_FEAT + 7 * D_FEAT),
        ),
        "klms_bank_step": (
            lambda m: ops.rff_klms_bank_step(
                a["theta"], x0, y0, a["w"], a["b"], a["mu"], a["s"], mode=m),
            shared + 4 * (2 * BANK * D_FEAT + BANK * (D_IN + 3) + BANK),
            rows_step * (2 * D_IN * D_FEAT + 7 * D_FEAT),
        ),
        "bank_predict": (
            lambda m: ops.rff_bank_predict(
                a["theta"], xq, a["w"], a["b"], a["s"], mode=m),
            shared + 4 * (BANK * D_FEAT + BANK * Q * (D_IN + 1)),
            rows_pred * (2 * D_IN * D_FEAT + 5 * D_FEAT),
        ),
    }
    k = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_FEAT, device, "eye")
    kx0, ky0 = k["xs"][:, 0].contiguous(), k["ys"][:, 0].contiguous()
    cases["krls_bank_chunk"] = krls_chunk_case(k)
    cases["krls_bank_step"] = (
        lambda m: ops.rff_krls_bank_step(
            k["theta"], k["pmat"], kx0, ky0, k["w"], k["b"], k["beta"],
            k["s"], mode=m),
        *krls_cost(K_D_FEAT, 1),
    )
    from repro_torch.kernels.rff_krls_step import (
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    counts = {name: k_.route_launches for name, k_ in (
        ("krls_bank_chunk", rff_krls_bank_chunk_cuda),
        ("krls_bank_step", rff_krls_bank_step_cuda))}
    before = {name: dict(c) for name, c in counts.items()}
    out = {name: timed_case(*case) for name, case in cases.items()}
    for name, c in counts.items():
        check(c["resident"] > before[name]["resident"]
              and c["streaming"] == before[name]["streaming"],
              f"{name} at D = {K_D_FEAT} was timed off its resident route")
    # Both KRLS kernels' streaming routes where they are picked: the
    # serving bank at D = K_D_WIDE, past the resident triangle's shared
    # memory.
    kw = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_WIDE, device, "eye")
    kw0, kwy0 = kw["xs"][:, 0].contiguous(), kw["ys"][:, 0].contiguous()
    wide = {"krls_bank_chunk": timed_case(*krls_chunk_case(kw), plain_reps=5),
            "krls_bank_step": timed_case(
                lambda m: ops.rff_krls_bank_step(
                    kw["theta"], kw["pmat"], kw0, kwy0, kw["w"], kw["b"],
                    kw["beta"], kw["s"], mode=m),
                *krls_cost(K_D_WIDE, 1), plain_reps=5)}
    del kw, kw0, kwy0
    keys = ("ms", "ms_runs", "plain_ms", "bound_ms", "bound_by")
    for name, c in counts.items():
        check(c["streaming"] > before[name]["streaming"],
              f"{name} at D = {K_D_WIDE} was timed off its streaming route")
        row, tlen = out[name], CHUNK if name == "krls_bank_chunk" else 1
        row["routes"] = {
            "resident": {**{k_: row[k_] for k_ in keys}, "library_ms": None,
                         "shape": [BANK, tlen, K_D_IN, K_D_FEAT]},
            "streaming": {**{k_: wide[name][k_] for k_ in keys},
                          "library_ms": None,
                          "shape": [BANK, tlen, K_D_IN, K_D_WIDE]}}
    keys = ("ms", "ms_runs", "plain_ms", "plain_ms_runs", "bound_ms",
            "bound_by")
    pred = out["bank_predict"]
    bf16 = timed_case(lambda m: ops.rff_bank_predict(
        a["theta"], xq, a["w"], a["b"], a["s"], mode=m, precision="bf16"),
        shared + 4 * (BANK * D_FEAT + BANK * Q * (D_IN + 1)), 0.0)
    t_bytes = bf16["bytes"] / HBM_BYTES_PER_S
    t_ops = (rows_pred * 2 * D_IN * D_FEAT / BF16_OPS_PER_S
             + rows_pred * 5 * D_FEAT / F32_OPS_PER_S)
    bf16.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    pred["bf16"] = {**{k_: bf16[k_] for k_ in keys}, "library_ms": None,
                    "shape": [BANK, Q, D_IN, D_FEAT]}
    kq = torch.from_numpy(
        rng.normal(size=(BANK, Q, K_D_IN)).astype(np.float32)).to(device)
    k_shared = 4 * (K_D_IN * K_D_FEAT + 2 * K_D_FEAT)
    krls_read = timed_case(
        lambda m: ops.rff_bank_predict(k["theta"], kq, k["w"], k["b"], k["s"],
                                       mode=m),
        k_shared + 4 * (BANK * K_D_FEAT + BANK * Q * (K_D_IN + 1)),
        rows_pred * (2 * K_D_IN * K_D_FEAT + 5 * K_D_FEAT))
    pred["krls_read"] = {**{k_: krls_read[k_] for k_ in keys},
                         "library_ms": None,
                         "shape": [BANK, Q, K_D_IN, K_D_FEAT]}
    # The read's most launched shape: one tenant (the policy tier's reads,
    # the quarantine's predict_row) at the KLMS serving widths.
    one = timed_case(
        lambda m: ops.rff_bank_predict(a["theta"][:1], xq[:1], a["w"],
                                       a["b"], a["s"], mode=m),
        shared + 4 * (D_FEAT + Q * (D_IN + 1)),
        Q * (2 * D_IN * D_FEAT + 5 * D_FEAT))
    pred["one_tenant"] = {**{k_: one[k_] for k_ in keys}, "library_ms": None,
                          "shape": [1, Q, D_IN, D_FEAT]}
    emit({"phase": "times", "shapes": {"B": BANK, "T": CHUNK, "d": D_IN,
                                       "D": D_FEAT, "Q": Q},
          "krls_shapes": {"B": BANK, "T": CHUNK, "d": K_D_IN, "D": K_D_FEAT},
          "kernels": out,
          "library_ms": "null: no single PyTorch call computes any of the "
                        "five functions"})
    return out


def f32_tensor(rng, *shape, scale=1.0, device=None):
    return torch.from_numpy(
        (scale * rng.normal(size=shape)).astype(np.float32)).to(device)


def feature_inputs(rng, m, d, dfeat, device):
    """x (M, d), W (d, D) ~ N(0, 1/d), b ~ U[0, 2 pi], s = sqrt(2/D)."""
    from repro_torch.kernels.ref import default_scale

    return dict(
        x=f32_tensor(rng, m, d, device=device),
        w=f32_tensor(rng, d, dfeat, scale=1 / np.sqrt(d), device=device),
        b=torch.from_numpy(rng.uniform(0, 2 * np.pi, size=dfeat)
                           .astype(np.float32)).to(device),
        s=default_scale(dfeat, device=device),
    )


def f64_err(got, want) -> float:
    """max |got - want|, taken in float64."""
    return float((got.double() - want.double()).abs().max())


def rel_norm(got, want) -> float:
    """Frobenius norm of the difference over that of ``want``."""
    g, w = got.double(), want.double()
    den = float(torch.linalg.vector_norm(w))
    return float(torch.linalg.vector_norm(g - w)) / (den or 1.0)


FEATURE_SHAPES = [(256, D_IN, D_FEAT), (65536, D_IN, D_FEAT), (1, 1, 17),
                  (33, 5, 300)]  # (M, d, D)
# (T, d, D, chunk, normalized): the replay shape and the paper's (one
# chunk each at the default Tc), remainders at both widths, Tc = 1, and
# two chunks of the default Tc's cap, 512.
ELEMENT_CASES = [(256, D_IN, D_FEAT, None, False),
                 (256, D_IN, D_FEAT, 100, True),
                 (256, K_D_IN, K_D_FEAT, None, False),
                 (256, K_D_IN, K_D_FEAT, 48, True),
                 (40, K_D_IN, K_D_FEAT, 1, False),
                 (1024, D_IN, D_FEAT, 512, False)]
# The KLMS element kernel composes a chunk in closed form, not by the fold:
# at the replay shape its A and v must each be within WY_GATE times the
# f32 fold's own distance from a float64 fold, and in the stress case (d =
# 5, D = 300, mu = 1.5, where T's entries grow past 2) v within
# WY_STRESS_TOL of max |v| of the float64 fold.
WY_GATE, WY_STRESS_TOL, WY_STRESS_MU = 2.0, 1e-4, 1.5
# The KRLS element kernel forms a chunk as one weighted Gram, not by the
# fold: at these (T, d, D, beta) its g, Phi and r must each be within
# WY_GATE times the f32 fold's own distance from a float64 fold.
GRAM_CASES = [(LOG_CAP, 5, 300, 0.9995), (LOG_CAP, 128, 2048, 0.99)]


def phase_replay_kernels(rng, device) -> dict:
    """The replay kernels against their plain versions, the KLMS element's
    numerical gate against a float64 fold, and their exact contracts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_features import rff_features_cuda
    from repro_torch.kernels.rff_scan import (
        rff_klms_chunk_elements_cuda,
        rff_krls_chunk_elements_cuda,
    )

    errs = dict.fromkeys(("rff_features", "klms_chunk_elements",
                          "krls_chunk_elements"), 0.0)
    rel = dict(errs)
    feat = {}
    for m, d, dfeat in FEATURE_SHAPES:
        a = feature_inputs(rng, m, d, dfeat, device)
        smax = float(a["s"].abs().max())
        for prec, tol in ((None, FEAT_TOL), ("bf16", FEAT_BF16_TOL)):
            got = ops.rff_features(a["x"], a["w"], a["b"], a["s"],
                                   mode="cuda", precision=prec)
            want = ops.rff_features(a["x"], a["w"], a["b"], a["s"],
                                    mode="ref", precision=prec)
            check(got.dtype == want.dtype and got.shape == (m, dfeat),
                  f"rff_features {m, d, dfeat} {prec}: dtype or shape")
            check(bool(torch.isfinite(got.float()).all()),
                  f"rff_features {m, d, dfeat}: non-finite output")
            e = max_err(got, want)
            check(e <= tol * smax, f"rff_features {m, d, dfeat} {prec}: off "
                  f"by {e:.3g} = {e / smax:.3g} of max|s| (tol {tol})")
            feat[f"{m}x{d}->{dfeat} {prec or 'f32'}"] = e / smax
            if prec is None:
                errs["rff_features"] = max(errs["rff_features"], e)
                rel["rff_features"] = max(rel["rff_features"], rel_norm(got, want))
        del a, got, want

    for tlen, d, dfeat, chunk, norm in ELEMENT_CASES:
        a = feature_inputs(rng, tlen, d, dfeat, device)
        ys = f32_tensor(rng, tlen, device=device)
        common = (a["x"], ys, a["w"], a["b"])
        for name, op, hp, kw in (
            ("klms_chunk_elements", ops.rff_klms_chunk_elements, MU,
             dict(normalized=norm)),
            ("krls_chunk_elements", ops.rff_krls_chunk_elements, K_BETA, {}),
        ):
            got = op(*common, hp, a["s"], mode="cuda", chunk=chunk, **kw)
            want = op(*common, hp, a["s"], mode="ref", chunk=chunk, **kw)
            label = f"{name} T={tlen} d={d} D={dfeat} Tc={chunk} norm={norm}"
            errs[name] = max(errs[name], hold(label, got, want, F32_TOL))
            r = max(rel_norm(g, w) for g, w in zip(got, want))
            check(r <= F32_TOL, f"{label}: normwise {r:.3g} (tol {F32_TOL})")
            rel[name] = max(rel[name], r)
            del got, want

    # The closed form's numerical gate against a float64 fold.
    wy = {}
    for label, d, dfeat, mu, norms in (
            ("replay", D_IN, D_FEAT, MU, (False, True)),
            ("stress", K_D_IN, K_D_FEAT, WY_STRESS_MU, (False,))):
        a = feature_inputs(rng, LOG_CAP, d, dfeat, device)
        ys = f32_tensor(rng, LOG_CAP, device=device)
        f64 = [t.double() for t in (a["x"], ys, a["w"], a["b"])]
        for norm in norms:
            got = ops.rff_klms_chunk_elements(a["x"], ys, a["w"], a["b"], mu,
                                              a["s"], mode="cuda",
                                              normalized=norm)
            plain = ops.rff_klms_chunk_elements(a["x"], ys, a["w"], a["b"],
                                                mu, a["s"], mode="ref",
                                                normalized=norm)
            exact = ops.rff_klms_chunk_elements(*f64, mu, a["s"].double(),
                                                mode="ref", normalized=norm)
            dist = {f"{k}_{part}": f64_err(x[i], exact[i])
                    for k, x in (("kernel", got), ("fold", plain))
                    for i, part in enumerate(("a", "v"))}
            dist["max_abs_v"] = float(exact[1].abs().max())
            tag = f"klms_chunk_elements {label} D={dfeat} norm={norm}"
            if label == "replay":
                for part in ("a", "v"):
                    check(dist[f"kernel_{part}"]
                          <= WY_GATE * dist[f"fold_{part}"],
                          f"{tag}: {part} is {dist[f'kernel_{part}']:.3g} from "
                          f"float64, the f32 fold {dist[f'fold_{part}']:.3g} "
                          f"(gate x{WY_GATE})")
            else:
                check(dist["kernel_v"] <= WY_STRESS_TOL * dist["max_abs_v"],
                      f"{tag}: v is {dist['kernel_v']:.3g} from float64 "
                      f"(tol {WY_STRESS_TOL} of max|v| {dist['max_abs_v']:.3g})")
            wy[f"{label} norm={norm}"] = dist
            del got, plain, exact
        del a, f64
    gram = {}
    for tlen, d, dfeat, beta in GRAM_CASES:
        a = feature_inputs(rng, tlen, d, dfeat, device)
        ys = f32_tensor(rng, tlen, device=device)
        f32 = (a["x"], ys, a["w"], a["b"], beta, a["s"])
        got = ops.rff_krls_chunk_elements(*f32, mode="cuda")
        plain = ops.rff_krls_chunk_elements(*f32, mode="ref")
        exact = ops.rff_krls_chunk_elements(
            *(t.double() for t in (a["x"], ys, a["w"], a["b"])), beta,
            a["s"].double(), mode="ref")
        dist = {f"{k}_{part}": f64_err(x[i], exact[i])
                for k, x in (("kernel", got), ("fold", plain))
                for i, part in enumerate(("g", "phi", "r"))}
        tag = f"krls_chunk_elements D={dfeat} beta={beta}"
        for part in ("g", "phi", "r"):
            check(dist[f"kernel_{part}"] <= WY_GATE * dist[f"fold_{part}"],
                  f"{tag}: {part} is {dist[f'kernel_{part}']:.3g} from "
                  f"float64, the f32 fold {dist[f'fold_{part}']:.3g} "
                  f"(gate x{WY_GATE})")
        check(torch.equal(got[1][0], got[1][0].T), f"{tag}: Phi != Phi^T")
        for tile in (64, 32):
            forced = rff_krls_chunk_elements_cuda(
                a["x"][None], ys[None], a["w"], a["b"], beta, None, a["s"],
                _tile=tile)
            check(all(torch.equal(u, w) for u, w in zip(forced, got)),
                  f"{tag}: the {tile}-tile product changes bits")
        gram[f"D={dfeat} beta={beta}"] = dist
        del a, got, plain, exact, forced
    # A feature row's bits: alone, in a 256-row call and in a call of the
    # read block's 65536 rows, on every tile plan.
    a = feature_inputs(rng, BANK * Q, D_IN, D_FEAT, device)
    for prec in (None, "bf16"):
        args = (a["w"], a["b"], a["s"], prec)
        one = rff_features_cuda(a["x"][300:301].contiguous(), *args)
        for rows in (None, 128, 32):
            block = rff_features_cuda(a["x"][256:512].contiguous(), *args,
                                      _rows=rows)
            whole = rff_features_cuda(a["x"], *args, _rows=rows)
            check(torch.equal(block[44], one[0])
                  and torch.equal(whole[300], one[0]),
                  f"rff_features {prec or 'f32'} rows={rows}: a row's bits "
                  "depend on the call")
            del block, whole
    del a
    # Exact contracts at the paper's width: chunk 1 of 3 fully masked.
    a = feature_inputs(rng, 24, K_D_IN, K_D_FEAT, device)
    ys = f32_tensor(rng, 24, device=device)
    xs_c, ys_c = a["x"].reshape(3, 8, K_D_IN), ys.reshape(3, 8)
    mask = torch.ones_like(ys_c)
    mask[1] = 0
    args = (xs_c, ys_c, a["w"], a["b"])
    av, vv = rff_klms_chunk_elements_cuda(*args, MU, mask, a["s"])
    check(torch.equal(av[1], torch.eye(K_D_FEAT, device=device))
          and not bool(vv[1].any()), "masked KLMS chunk is not (I, 0)")
    g, phi, r = rff_krls_chunk_elements_cuda(*args, K_BETA, mask, a["s"])
    check(float(g[1]) == 1.0 and not bool(phi[1].any())
          and not bool(r[1].any()), "masked KRLS chunk is not (1, 0, 0)")
    check(torch.equal(phi[0], phi[0].T), "KRLS chunk's Phi != Phi^T")
    # Two calls agree bit for bit; a chunk alone equals it among others.
    again = rff_klms_chunk_elements_cuda(*args, MU, mask, a["s"])
    check(torch.equal(again[0], av) and torch.equal(again[1], vv),
          "klms_chunk_elements: two calls differ")
    again = rff_krls_chunk_elements_cuda(*args, K_BETA, mask, a["s"])
    check(all(torch.equal(u, w) for u, w in zip(again, (g, phi, r))),
          "krls_chunk_elements: two calls differ")
    alone = rff_krls_chunk_elements_cuda(
        xs_c[2:].contiguous(), ys_c[2:].contiguous(), a["w"], a["b"], K_BETA,
        None, a["s"])
    check(all(torch.equal(u[0], w[2]) for u, w in zip(alone, (g, phi, r))),
          "krls_chunk_elements: a chunk alone differs from it among others")
    # A remainder chunk (4 live + 12 masked ticks) equals its live ticks.
    x20, y20 = a["x"][:20], ys[:20]
    for op, hp in ((ops.rff_klms_chunk_elements, MU),
                   (ops.rff_krls_chunk_elements, K_BETA)):
        padded = op(x20, y20, a["w"], a["b"], hp, a["s"], mode="cuda",
                    chunk=16)
        alone = op(x20[16:], y20[16:], a["w"], a["b"], hp, a["s"],
                   mode="cuda", chunk=4)
        check(all(torch.equal(p[1], q[0]) for p, q in zip(padded, alone)),
              f"{op.__name__}: the remainder chunk differs from its live ticks")
    torch.cuda.synchronize()
    emit({"phase": "replay_kernels", "feature_shapes": FEATURE_SHAPES,
          "feature_err_of_max_s": feat,
          "element_cases": [list(c) for c in ELEMENT_CASES],
          "max_abs_err": errs, "max_normwise_err": rel,
          "klms_wy_vs_float64": wy, "krls_gram_vs_float64": gram,
          "tolerance": {"features_of_max_s": FEAT_TOL,
                        "features_bf16_of_max_s": FEAT_BF16_TOL,
                        "elements_elementwise": F32_TOL,
                        "elements_normwise": F32_TOL,
                        "klms_wy_gate_of_fold": WY_GATE,
                        "krls_gram_gate_of_fold": WY_GATE,
                        "klms_wy_stress_v_of_max_v": WY_STRESS_TOL},
          "exact": {"masked_chunk_is_identity": True,
                    "two_calls_agree": True,
                    "remainder_chunk_eq_live_ticks": True,
                    "krls_chunk_alone_eq_among_others": True,
                    "krls_phi_symmetric": True,
                    "krls_tiles_agree": True,
                    "feature_row_bits_independent_of_call": True}})
    return errs


def lifecycle_history(rng, d, bank):
    """Observations before and during eviction. Tenant 0 overflows the
    ring (300 + 40 arrivals), tenant 1 has 181 + 20 (not a multiple of the
    flush chunk), tenant 2 a single tick, tenant 3 none; tenants 4 .. 63
    get 12 + 4 each and are never evicted."""
    dirs = rng.normal(size=(bank, d)) / np.sqrt(d)

    def obs(counts):
        tenants = np.repeat(np.arange(len(counts)), counts)
        rng.shuffle(tenants)
        xs = rng.normal(size=(len(tenants), d)).astype(np.float32)
        proj = np.einsum("nd,nd->n", xs, dirs[tenants])
        ys = 1.0 + 0.5 * np.sin(proj) + 0.05 * rng.normal(size=len(tenants))
        return list(zip(tenants.tolist(), xs, ys.astype(np.float32).tolist()))

    before = obs([300, 181, 1, 0] + [12] * 60)
    during = obs([40, 20, 0, 0] + [4] * 60)
    after = obs([8, 8, 8, 8] + [4] * 60)
    return before, during, after


EVICTED = (0, 1, 2, 3)


def drive(servers, observations):
    for srv in servers:
        for t, x, y in observations:
            srv.submit(t, x, y)
        srv.drain()


def readmit_all(srv) -> dict:
    """Readmit every evicted tenant; wall milliseconds per tenant."""
    ms = {}
    for t in EVICTED:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.readmit(t)
        torch.cuda.synchronize()
        ms[t] = (time.perf_counter() - t0) * 1e3
    return ms


def untouched_equal(srv, ctl) -> bool:
    got, want = srv.queue.state, ctl.queue.state
    return all(torch.equal(g[len(EVICTED):], w[len(EVICTED):])
               for g, w in zip(got, want))


def phase_replay_server(seed, device, kernels, learner="klms",
                        family="rff",
                        modes=("blocked", "scan", "sequential")) -> dict:
    """The KLMS (or NKLMS) lifecycle: evict -> log -> readmit under every
    rebuild mode (or ``modes``), at the KLMS serving configuration with
    log_capacity=256, with the paper's rff map or another trig family.
    NKLMS writes through the generic chunk loop (no kernel), and reads and
    readmits through the KLMS kernels."""
    from repro_torch.core.klms import rff_klms_run
    from repro_torch.serve import make_server

    fm = family_map(family, seed, D_IN, D_FEAT, SIGMA, device)
    hp = dict(feature_map=fm, bank=BANK, chunk=CHUNK, mu=MU, device=device)
    normalized = learner == "nklms"
    ctl = make_server(learner, **hp)
    srv = {m: make_server(learner, log_capacity=LOG_CAP, rebuild_mode=m, **hp)
           for m in modes}
    ref = {m: make_server(learner, log_capacity=LOG_CAP, rebuild_mode=m,
                          mode="ref", **hp) for m in modes}
    rng = np.random.default_rng(seed + 3)
    before, during, after = lifecycle_history(rng, D_IN, BANK)
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, D_IN)).astype(np.float32)).to(device)
    lifecycle = [*srv.values(), *ref.values()]

    reset_launches(kernels)
    t0 = time.perf_counter()
    drive([ctl, *lifecycle], before)
    for s in lifecycle:
        for t in EVICTED:
            s.evict(t)
    drive([ctl, *lifecycle], during)
    readmit_ms = {m: readmit_all(srv[m]) for m in modes}
    for m in modes:
        readmit_all(ref[m])
    torch.cuda.synchronize()
    readmit_s = time.perf_counter() - t0

    report = {}
    ctl_theta = ctl.queue.state.theta
    for m in modes:
        s, r = srv[m], ref[m]
        log = s.snapshot_server.log
        check(not log.complete(0) and all(log.complete(t) for t in (1, 2, 3)),
              f"{m}: log completeness")
        check(log.size(0) == LOG_CAP and log.size(1) == 201
              and log.size(2) == 1 and log.size(3) == 0, f"{m}: log sizes")
        theta = s.queue.state.theta
        dist = {}
        for t in (1, 2):  # complete logs: the never-evicted control
            dist[f"vs_control_{t}"] = rel_norm(theta[t], ctl_theta[t])
            check(dist[f"vs_control_{t}"] <= REPLAY_REL,
                  f"{m}: tenant {t} is {dist[f'vs_control_{t}']:.3g} from "
                  f"the never-evicted control (tol {REPLAY_REL})")
        check(not bool(theta[3].any()), f"{m}: cold tenant 3 is not fresh")
        for t in (0, 1, 2):  # every log: rff_klms_run over the log itself
            xs, ys = (torch.from_numpy(a).to(device) for a in log.arrays(t))
            run, _ = rff_klms_run(fm, xs, ys, MU, normalized=normalized)
            dist[f"vs_run_{t}"] = rel_norm(theta[t], run.theta)
            if m == "sequential":
                check(torch.equal(theta[t], run.theta),
                      f"sequential readmit of tenant {t} is not rff_klms_run")
            check(dist[f"vs_run_{t}"] <= REPLAY_REL,
                  f"{m}: tenant {t} is {dist[f'vs_run_{t}']:.3g} from "
                  f"rff_klms_run over its log (tol {REPLAY_REL})")
            check(int(s.queue.state.step[t]) == log.size(t), f"{m}: step {t}")
        hold(f"{m} readmitted theta vs mode=ref",
             [theta[:len(EVICTED)]], [r.queue.state.theta[:len(EVICTED)]],
             SERVER_TOL)
        check(untouched_equal(s, ctl), f"{m}: an untouched tenant differs "
              "from the never-evicted control")
        dist["readmit_ms"] = readmit_ms[m]
        report[m] = dist

    drive([ctl, *lifecycle], after)  # training after readmission
    for m in modes:
        s, r = srv[m], ref[m]
        check(untouched_equal(s, ctl), f"{m}: untouched tenants drifted")
        hold(f"{m} predict_block after readmit", [s.predict_block(xq)],
             [r.predict_block(xq)], SERVER_TOL)
        for t in EVICTED:
            hold(f"{m} predict tenant {t} after readmit",
                 [s.predict(t, xq[t])], [r.predict(t, xq[t])], SERVER_TOL)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(kernels, (
        "rff_features", "klms_chunk_elements", "bank_predict",
        *(() if normalized else ("klms_bank_chunk",))))
    emit({"phase": "replay_server", "learner": learner, "family": family,
          "bank": BANK,
          "d": D_IN, "D": D_FEAT, "chunk": CHUNK, "mu": MU,
          "log_capacity": LOG_CAP, "submits_per_server":
          len(before) + len(during) + len(after), "modes": report,
          "tolerance": {"vs_control_and_run_rel": REPLAY_REL,
                        "vs_ref_server": SERVER_TOL},
          "bitwise": {"sequential_eq_rff_klms_run": True,
                      "untouched_eq_control": True},
          "launches": launches, "seconds_to_readmit": readmit_s,
          "seconds": seconds})
    return launches


def phase_krls_replay_server(seed, device, kernels, family="rff",
                             modes=("blocked", "scan")) -> dict:
    """The KRLS lifecycle at the paper's section 6 settings under "blocked"
    and "scan" (or ``modes``), with the paper's rff map or another trig
    family. At lam = 1e-4 f32 itself is the limit (PR 12's finding), so
    readmitted state, and reads and state after more training, are held
    within BUDGET times the plain path's own distance from the same server
    run in float64; untouched tenants' state and reads equal the
    never-evicted control's bit for bit."""
    from repro_torch.serve import make_server

    fm = family_map(family, seed, K_D_IN, K_D_FEAT, K_SIGMA, device)
    fm64 = f64_map(fm)
    hp = dict(bank=BANK, chunk=CHUNK, lam=K_LAM, beta=K_BETA, device=device)
    ctl = make_server("krls", feature_map=fm, **hp)
    trio = {m: [make_server("krls", feature_map=f, log_capacity=LOG_CAP,
                            rebuild_mode=m, mode=k, **hp)
                for f, k in ((fm, "auto"), (fm, "ref"), (fm64, "ref"))]
            for m in modes}  # kernel, plain f32, plain float64
    rng = np.random.default_rng(seed + 4)
    before, during, after = lifecycle_history(rng, K_D_IN, BANK)
    xq = rng.normal(size=(BANK, Q, K_D_IN)).astype(np.float32)
    lifecycle = [s for servers in trio.values() for s in servers]

    reset_launches(kernels)
    t0 = time.perf_counter()
    drive([ctl, *lifecycle], before)
    for s in lifecycle:
        for t in EVICTED:
            s.evict(t)
    drive([ctl, *lifecycle], during)
    readmit_ms = {m: readmit_all(trio[m][0]) for m in modes}
    for m in modes:
        for s in trio[m][1:]:
            readmit_all(s)
    torch.cuda.synchronize()

    report, live = {}, [0, 1, 2]
    for m in modes:
        got, plain, exact = (s.queue.state for s in trio[m])
        log = trio[m][0].snapshot_server.log
        budget = {
            "theta": within_budget(f"{m} readmit theta", got.theta[live],
                                   plain.theta[live], exact.theta[live],
                                   normwise),
            "P": within_budget(f"{m} readmit P", got.pmat[live],
                               plain.pmat[live], exact.pmat[live], p_rel),
        }
        fresh = torch.eye(K_D_FEAT, device=device) / K_LAM
        check(not bool(got.theta[3].any()) and torch.equal(got.pmat[3], fresh),
              f"krls {m}: cold tenant 3 is not the fresh row")
        check(all(int(got.step[t]) == log.size(t) for t in live),
              f"krls {m}: steps")
        check(untouched_equal(trio[m][0], ctl), f"krls {m}: an untouched "
              "tenant differs from the never-evicted control")
        budget["vs_control_theta"] = normwise(got.theta[[1, 2]],
                                              ctl.queue.state.theta[[1, 2]])
        budget["readmit_ms"] = readmit_ms[m]
        report[m] = budget

    drive([ctl, *lifecycle], after)  # training after readmission
    ctl_blk = ctl.predict_block(xq)
    for m in modes:
        srv = trio[m][0]
        check(untouched_equal(srv, ctl), f"krls {m}: untouched tenants drifted")
        blocks = [s.predict_block(xq) for s in trio[m]]
        check(bool(torch.isfinite(blocks[0]).all())
              and blocks[0].shape == (BANK, Q),
              f"krls {m}: reads after readmit not finite or misshapen")
        check(torch.equal(blocks[0][len(EVICTED):], ctl_blk[len(EVICTED):]),
              f"krls {m}: untouched tenants' reads differ from the control's")
        states = [s.queue.state for s in trio[m]]
        report[m]["after_training"] = {
            "predict_block": within_budget(f"{m} reads after readmit",
                                           *blocks, normwise),
            "theta": within_budget(f"{m} theta after readmit",
                                   *[st.theta for st in states], normwise),
            "P": within_budget(f"{m} P after readmit",
                               *[st.pmat for st in states], p_rel),
        }
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(kernels, ("rff_features", "krls_chunk_elements",
                                       "krls_bank_chunk", "bank_predict"))
    emit({"phase": "krls_replay_server", "learner": "krls",
          "family": family, "bank": BANK,
          "d": K_D_IN, "D": K_D_FEAT, "sigma": K_SIGMA, "lam": K_LAM,
          "beta": K_BETA, "chunk": CHUNK, "log_capacity": LOG_CAP,
          "modes": report,
          "budget": {"factor": BUDGET, "floor": BUDGET_FLOOR},
          "bitwise": {"untouched_state_and_reads_eq_control": True},
          "launches": launches, "seconds": seconds})
    return launches


def phase_replay_times(rng, device) -> dict:
    """The replay kernels, their plain versions and their bounds at the
    replay shapes, and readmission wall time per family, mode and width.

    Operations, counting a multiply-add as two: the feature map's 2 d D
    plus bias, cos (as one operation) and scale per output. The KLMS
    element has two counts, and its bound takes the smaller, the least
    work known for the function: the fold's, a live tick 4 D^2 (z A, one
    multiply-add per element, and the rank-1 update, one multiply-add per
    element once mu_eff z_i is formed per row) plus 5 D (z . v, v's update
    and mu_eff z); and the closed form's (what the kernel does), per chunk
    Tc (Tc + 1) D (the Gram: G is symmetric, and the solve reads only its
    lower triangle and diagonal), Tc^2 D (T Z, T triangular), 2 D^2 Tc
    (the product), Tc^3 / 3 (the solve, a triangular inverse), 2 Tc D (v)
    and 2 Tc^2 (c). The KRLS element likewise: the fold's, a live tick 3
    D^2 (beta Phi + z_i z_j: a multiply and a multiply-add; a masked tick
    is skipped, so no mask multiply) plus 3 D for r; and the closed form's
    (what the kernel does), per chunk D (D + 1) Tc (the lower triangle of
    Z^T (w Z), diagonal included), Tc D (w Z) and 2 Tc D (r), the
    features added to both. It is timed at the paper's shape and at D =
    2048. Every tick of these inputs is live. Bytes: each input read once
    and each output written once (the (D, D) element per chunk).
    """
    from repro_torch.core.scan import replay_klms, replay_krls
    from repro_torch.features import rff_map
    from repro_torch.kernels import ops

    out = {}

    def measure(name, fn, nbytes, nops, shape):
        # The plain element folds take tens of ms: fewer readings.
        out[name] = dict(timed_case(fn, nbytes, nops, plain_reps=5),
                         shape=shape)

    shared = lambda d, dfeat: 4 * (d * dfeat + 2 * dfeat)  # W, b, s
    for label, m in (("rff_features", LOG_CAP), ("rff_features_read_block",
                                                 BANK * Q)):
        a = feature_inputs(rng, m, D_IN, D_FEAT, device)
        measure(label, lambda mode: ops.rff_features(
            a["x"], a["w"], a["b"], a["s"], mode=mode),
            shared(D_IN, D_FEAT) + 4 * m * (D_IN + D_FEAT),
            m * (2 * D_IN * D_FEAT + 3 * D_FEAT), shape=[m, D_IN, D_FEAT])
        del a
    a = feature_inputs(rng, LOG_CAP, D_IN, D_FEAT, device)
    ys = f32_tensor(rng, LOG_CAP, device=device)
    tc, feat = LOG_CAP, LOG_CAP * (2 * D_IN * D_FEAT + 3 * D_FEAT)
    fold_ops = feat + tc * (4 * D_FEAT ** 2 + 5 * D_FEAT)
    wy_ops = feat + (tc * (tc + 1) * D_FEAT + tc ** 2 * D_FEAT
                     + 2 * D_FEAT ** 2 * tc + tc ** 3 // 3
                     + 2 * tc * D_FEAT + 2 * tc ** 2)
    measure("klms_chunk_elements", lambda mode: ops.rff_klms_chunk_elements(
        a["x"], ys, a["w"], a["b"], MU, a["s"], mode=mode),
        shared(D_IN, D_FEAT) + 4 * (LOG_CAP * (D_IN + 1)
                                    + D_FEAT * D_FEAT + D_FEAT),
        min(fold_ops, wy_ops), shape=[LOG_CAP, D_IN, D_FEAT])
    out["klms_chunk_elements"].update(ops_fold=fold_ops, ops_wy=wy_ops)
    for label, d, dfeat, beta in (("krls_chunk_elements", K_D_IN, K_D_FEAT,
                                   K_BETA),
                                  ("krls_chunk_elements_d2048", D_IN, D_FEAT,
                                   0.99)):
        k = feature_inputs(rng, LOG_CAP, d, dfeat, device)
        kys = f32_tensor(rng, LOG_CAP, device=device)
        feat = tc * (2 * d * dfeat + 3 * dfeat)
        fold_ops = feat + tc * (3 * dfeat ** 2 + 3 * dfeat)
        gram_ops = feat + dfeat * (dfeat + 1) * tc + 3 * tc * dfeat
        measure(label, lambda mode: ops.rff_krls_chunk_elements(
            k["x"], kys, k["w"], k["b"], beta, k["s"], mode=mode),
            shared(d, dfeat) + 4 * (LOG_CAP * (d + 1) + 1 + dfeat * dfeat
                                    + dfeat),
            min(fold_ops, gram_ops), shape=[LOG_CAP, d, dfeat])
        out[label].update(ops_fold=fold_ops, ops_gram=gram_ops)
        del k

    def wall_ms(fn, reps=3) -> float:
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    readmit = {}
    for d, dfeat in ((D_IN, D_FEAT), (K_D_IN, K_D_FEAT)):
        fm = rff_map(torch.Generator().manual_seed(7), d, dfeat, SIGMA,
                     device=device)
        xs = f32_tensor(rng, LOG_CAP, d, device=device)
        ys = f32_tensor(rng, LOG_CAP, device=device)
        for mode in ("sequential", "scan", "blocked"):
            readmit[f"klms D={dfeat} {mode}"] = wall_ms(
                lambda: replay_klms(fm, xs, ys, MU, mode=mode))
            readmit[f"krls D={dfeat} {mode}"] = wall_ms(
                lambda: replay_krls(fm, xs, ys, K_LAM, K_BETA, mode=mode))
    emit({"phase": "replay_times", "T": LOG_CAP, "kernels": out,
          "replay_wall_ms_T256": readmit,
          "library_ms": "null: no single PyTorch call computes any of the "
                        "three functions"})
    return out


# ---------------------------------------------------------------------------
# The LM slice: qwen2-0.5b at its published width, RFF attention and GQA
# ---------------------------------------------------------------------------

# qwen2-0.5b (src/repro/configs/qwen2_0_5b.py): 24 layers, d_model 896, 14
# heads of 64, 2 KV heads, d_ff 4864, vocab 151936 (padded to 152064), tied
# embeddings, bf16; with_rff_attention keeps D = 256, rff_chunk 256. Served
# at B = 4: a prefill step of 2048 tokens, and 32 greedy tokens after a
# 16-token prompt.
LM_ARCH, LM_B, LM_S, LM_PROMPT, LM_NEW, LM_GQA_NEW = "qwen2-0.5b", 4, 2048, 16, 32, 8
# Attention kernels against their plain versions, relative to max|plain|:
# 1e-4 at f32 (other summation orders in every product and in the online
# softmax), 2e-2 under bf16 (a feature or an output that crosses a bf16
# rounding boundary moves by one bf16 ulp, 2^-8 relative).
ATTN_TOL, ATTN_BF16_TOL = 1e-4, 2e-2
# The model's logits. The f32 copy: kernels against kernel_mode="ref" at
# 1e-4 of max|logit| (f32 differences of ~1e-6 per layer, over 24 layers
# and the 896-wide head). In bf16 the residual stream is rounded to bf16
# after every layer, which turns f32-level kernel differences into
# one-ulp flips (2^-8) that the later layers carry: the bf16 kernel path
# must be no farther from the f32 model than LM_BUDGET times the bf16
# plain path is, plus LM_BUDGET_FLOOR of max|logit|.
LM_F32_TOL, LM_BUDGET, LM_BUDGET_FLOOR = 1e-4, 2.0, 1e-3
LM_REPLACES = {
    "rff_decode_block": "src/repro/kernels/rff_attention.py:235",
    "rff_linear_attention": "src/repro/kernels/rff_attention.py:87",
    "flash_attention": "src/repro/kernels/flash_attention.py:80",
}
LM_SOURCES = {
    "rff_decode_block": "src/repro_torch/csrc/rff_attention.cu",
    "rff_linear_attention": "src/repro_torch/csrc/rff_attention.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
}
# Each route of the kernels that have two, and its source (the KRLS step's
# resident route is the resident chunk kernel at T = 1).
ROUTE_SOURCES = {
    "flash_attention": {
        "tensor_core": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "cuda_core": "src/repro_torch/csrc/flash_attention.cu"},
    "krls_bank_chunk": {"resident": "src/repro_torch/csrc/krls_bank.cu",
                        "streaming": "src/repro_torch/csrc/krls_bank.cu"},
    "krls_bank_step": {"resident": "src/repro_torch/csrc/krls_bank.cu",
                       "streaming": "src/repro_torch/csrc/krls_bank.cu"},
}
# (BH, dh, D, dv): qwen2-0.5b's decode at B = 4, llama3-8b's head width,
# padded shapes.
DECODE_SHAPES = [(56, 64, 256, 64), (32, 128, 256, 128), (3, 16, 40, 24)]
# (BH, S, D, dv, chunk): qwen2-0.5b's prefill, llama3-8b's head width, a
# padded shape, a long sequence (64 chunks of the kernels' 64 rows, 34 MB
# an input).
LINEAR_SHAPES = [(56, LM_S, 256, 64, 256), (8, 512, 256, 128, 256),
                 (3, 192, 40, 24, 64), (8, 4096, 256, 64, 256)]
# (BH, S, dh, dv): qwen2-0.5b's, llama3-8b's and a padded head, then the
# heads of src/repro/configs whose q/k and v widths differ or pass 128:
# deepseek-v2-lite's MLA (192, 128), minicpm3's (96, 64), recurrentgemma's
# 256 (two V passes on the bf16 route).
FLASH_SHAPES = [(56, LM_S, 64, 64), (32, 1024, 128, 128), (3, 100, 24, 24),
                (8, 512, 192, 128), (8, 512, 96, 64), (4, 512, 256, 256)]
DECODE_CALLS = 20  # one-token decode calls per profiled timing
PROFILE_TRIES = 3  # profiles of a prefill until one shows what is checked
# Kernel 10's launches (csrc/rff_attention.cu): the state walk over chunks
# (S_prev, z_prev) and the outputs; and the op only its plain version runs
# (the chunk's causal mask, torch.tril).
LINEAR_PHASE_KERNELS = ("linear_state_kernel", "linear_output_kernel")


def hold_rel(name: str, got, want, rel: float) -> tuple[float, float, float]:
    """Fail unless max|got - want| <= rel * max|want| for each pair.
    Returns the largest absolute difference, the absolute tolerance
    (rel * max|want|) of the pair it came from, and the largest share of
    max|want| any difference was."""
    worst = worst_tol = share = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        err, scale = max_err(g, w), float(w.float().abs().max())
        check(err <= rel * scale, f"{name}: off by {err:.3g}, tolerance "
              f"{rel} of max|want| {scale:.3g}")
        if err >= worst:
            worst, worst_tol = err, rel * scale
        share = max(share, err / scale if scale else 0.0)
    return worst, worst_tol, share


def decode_inputs(rng, bh, tlen, dh, dfeat, dv, kind, device):
    """The decode kernel's inputs: a warm state, pre-projected tokens at
    the attention layer's dh^-1/4 scale, W ~ N(0, 1), the kind's scale."""
    from repro_torch.kernels.ref import default_decode_scale

    return (f32_tensor(rng, bh, dfeat, dv, scale=0.1, device=device).abs(),
            f32_tensor(rng, bh, dfeat, scale=0.1, device=device).abs() + 0.1,
            f32_tensor(rng, bh, tlen, dh, scale=dh ** -0.25, device=device),
            f32_tensor(rng, bh, tlen, dh, scale=dh ** -0.25, device=device),
            f32_tensor(rng, bh, tlen, dv, device=device),
            f32_tensor(rng, dh, dfeat, device=device),
            f32_tensor(rng, dfeat, device=device),
            default_decode_scale(dfeat, kind, device))


def positive(rng, *shape, device=None):
    """softplus(N(0, 1)) + 0.01: positive features, as PRF gives."""
    return torch.nn.functional.softplus(
        f32_tensor(rng, *shape, device=device)) + 0.01


def decode_tile_agrees(args, kw) -> bool:
    """Fail unless the decode block's first dv tile (outputs and state)
    equals a call on those columns of S and v alone, and z is the same."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import DECODE_TILE_COLS

    sm, zv, q, k, v, w, b, s = args
    full = ops.rff_attention_decode_block(*args, mode="cuda", **kw)
    cols = min(DECODE_TILE_COLS, v.shape[-1])
    first = ops.rff_attention_decode_block(
        sm[..., :cols].contiguous(), zv, q, k, v[..., :cols].contiguous(), w,
        b, s, mode="cuda", **kw)
    same = (torch.equal(full[0][..., :cols], first[0])
            and torch.equal(full[1][..., :cols], first[1])
            and torch.equal(full[2], first[2]))
    check(same, f"decode block {tuple(q.shape)}, dv {v.shape[-1]}: the first "
          "dv tile differs from a call on its columns")
    return same


def phase_lm_kernels(rng, device) -> dict:
    """Kernels 9-11 against their plain versions at qwen2-0.5b's shapes,
    llama3-8b's head width and padded shapes; at every decode head a block
    of T equals T one-token launches bit for bit; the first dv tile of
    both RFF kernels equals a call on its columns alone, and two
    linear-attention launches give the same bits."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import (
        LINEAR_TILE_COLS,
        default_decode_block_t,
    )

    errs = dict.fromkeys(LM_REPLACES, 0.0)
    tols = dict.fromkeys(LM_REPLACES, 0.0)
    rels = dict.fromkeys(LM_REPLACES, 0.0)
    flash_routes = {route: {"max_abs_err": 0.0, "err_of_max_plain": 0.0,
                            "tolerance_of_max_plain": tol}
                    for route, tol in (("tensor_core", ATTN_BF16_TOL),
                                       ("cuda_core", ATTN_TOL))}
    bitwise, tiles = {}, {}

    def note(name, err):
        if err[0] >= errs[name]:
            errs[name], tols[name] = err[0], err[1]
        rels[name] = max(rels[name], err[2])

    for bh, dh, dfeat, dv in DECODE_SHAPES:
        block_t = default_decode_block_t(dfeat, dv, dh)
        for kind in ("prf", "trig"):
            for tlen in (1, block_t, block_t + 3):
                args = decode_inputs(rng, bh, tlen, dh, dfeat, dv, kind, device)
                for prec in (None, "bf16"):
                    kw = dict(feature_kind=kind, normalize=kind == "prf",
                              precision=prec)
                    e = hold_rel(f"decode {kind} {prec} {bh, tlen, dh, dfeat, dv}",
                                 ops.rff_attention_decode_block(*args, mode="cuda", **kw),
                                 ops.rff_attention_decode_block(*args, mode="ref", **kw),
                                 ATTN_BF16_TOL if prec else ATTN_TOL)
                    if not prec:
                        note("rff_decode_block", e)
                    if tlen == block_t + 3:
                        blk = ops.rff_attention_decode_block(*args, mode="cuda", **kw)
                        sm, zv, q, k, v, w, b, s = args
                        outs = []
                        for i in range(tlen):
                            o, sm, zv = ops.rff_attention_decode_block(
                                sm, zv, q[:, i:i + 1].contiguous(),
                                k[:, i:i + 1].contiguous(),
                                v[:, i:i + 1].contiguous(), w, b, s,
                                mode="cuda", **kw)
                            outs.append(o)
                        same = (torch.equal(blk[0], torch.cat(outs, 1))
                                and torch.equal(blk[1], sm)
                                and torch.equal(blk[2], zv))
                        check(same, f"decode block of {tlen} ({kind}, {prec}) "
                              "differs from one-token launches")
                        bitwise[f"{bh}_{kind}_{prec or 'f32'}_T{tlen}"] = True
                    if tlen == 1 or tlen == block_t + 3:
                        tiles[f"decode_{bh}_{kind}_{prec or 'f32'}_T{tlen}"] = (
                            decode_tile_agrees(args, kw))
                del args
    for bh, slen, dfeat, dv, chunk in LINEAR_SHAPES:
        q, k = (positive(rng, bh, slen, dfeat, device=device) for _ in range(2))
        v = f32_tensor(rng, bh, slen, dv, device=device)
        for normalize in (True, False):
            got = ops.rff_attention(q, k, v, mode="cuda", chunk=chunk,
                                    normalize=normalize)
            e = hold_rel(f"linear attention {bh, slen, dfeat, dv} {normalize}",
                         [got], [ops.rff_attention(q, k, v, mode="ref",
                                                   chunk=chunk,
                                                   normalize=normalize)],
                         ATTN_TOL)
            note("rff_linear_attention", e)
            # Two launches give the same bits; the first dv tile's columns
            # are those of a call on them alone.
            again = ops.rff_attention(q, k, v, mode="cuda", chunk=chunk,
                                      normalize=normalize)
            shape = (bh, slen, dfeat, dv)
            check(torch.equal(got, again),
                  f"linear attention {shape}: two launches differ")
            first = ops.rff_attention(
                q, k, v[..., :LINEAR_TILE_COLS].contiguous(), mode="cuda",
                chunk=chunk, normalize=normalize)
            check(torch.equal(got[..., :LINEAR_TILE_COLS], first),
                  f"linear attention {shape}: the first dv tile differs "
                  "from a call on its columns")
            tiles[f"linear_{bh}_{slen}_{dv}_{normalize}"] = True
            del got, again, first
        del q, k, v
    for bh, slen, dh, dv in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k = (f32_tensor(rng, bh, slen, dh, device=device).to(dtype)
                    for _ in range(2))
            v = f32_tensor(rng, bh, slen, dv, device=device).to(dtype)
            route = flash_routes["tensor_core" if dtype == torch.bfloat16
                                 else "cuda_core"]
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, mode="cuda", causal=causal)
                check(got.dtype == dtype, "flash output type")
                e = hold_rel(f"flash {dtype} {bh, slen, dh, dv} causal={causal}",
                             [got], [ops.flash_attention(q, k, v, mode="ref",
                                                         causal=causal)],
                             route["tolerance_of_max_plain"])
                route["max_abs_err"] = max(route["max_abs_err"], e[0])
                route["err_of_max_plain"] = max(route["err_of_max_plain"], e[2])
                if dtype == torch.float32:
                    note("flash_attention", e)
            del q, k, v
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels_vs_plain", "decode_shapes": DECODE_SHAPES,
          "linear_shapes": LINEAR_SHAPES, "flash_shapes": FLASH_SHAPES,
          "max_abs_err_f32": errs, "abs_tolerance_at_max_err_f32": tols,
          "max_err_of_max_plain_f32": rels,
          "tolerance_of_max_plain": {"f32": ATTN_TOL, "bf16": ATTN_BF16_TOL},
          "flash_routes": flash_routes,
          "bitwise_block_eq_one_token_launches": bitwise,
          "bitwise_dv_tiles_and_reruns": tiles})
    return errs, tols, rels, flash_routes


def lm_model(cfg, seed, device):
    from repro_torch.models import init_params

    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(gen, cfg, device=device), gen


def as_f32(params):
    """The same weights in f32 (the f32 copy of the model)."""
    if isinstance(params, dict):
        return {k: as_f32(v) for k, v in params.items()}
    if isinstance(params, list):
        return [as_f32(v) for v in params]
    return params.float()


def lm_budget(name, kernel, plain, exact) -> dict:
    """The bf16 kernel path's logits against the bf16 plain path's, both
    measured from the f32 model's (see LM_BUDGET)."""
    scale = float(exact.float().abs().max())
    d_kernel, d_plain = max_err(kernel, exact), max_err(plain, exact)
    check(bool(torch.isfinite(kernel).all()), f"{name}: non-finite logits")
    check(d_kernel <= LM_BUDGET * d_plain + LM_BUDGET_FLOOR * scale,
          f"{name}: kernel path {d_kernel:.3g} from the f32 model, plain "
          f"path {d_plain:.3g} (budget {LM_BUDGET}x + {LM_BUDGET_FLOOR} of "
          f"{scale:.3g})")
    return {"kernel_from_f32": d_kernel, "plain_from_f32": d_plain,
            "kernel_from_plain": max_err(kernel, plain), "max_abs_logit": scale}


def phase_lm_server(seed, device, kernels) -> dict:
    """qwen2-0.5b with RFF attention at full width, bf16: make_prefill_step
    at B = 4, S = 2048 (kernel 10) and generate 32 greedy tokens after a
    16-token prompt (kernel 9, one launch per layer per token), held
    against kernel_mode="ref" and the f32 copy of the model."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import with_rff_attention
    from repro_torch.serve.serve_loop import generate, path_logits
    from repro_torch.train.steps import make_prefill_step

    cfg = with_rff_attention(get_config(LM_ARCH))
    params, gen = lm_model(cfg, seed, device)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=gen,
                           device=device)
    prompt = tokens[:, :LM_PROMPT].contiguous()
    names = ("rff_decode_block", "rff_linear_attention")
    with torch.inference_mode():
        reset_launches(kernels)
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
        toks = generate(params, cfg, prompt, steps=LM_NEW)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_launches(kernels, names)
        seen = path_logits(params, cfg, prompt, toks)
        steps = LM_PROMPT + LM_NEW - 1
        check(launches["rff_linear_attention"] == cfg.num_layers,
              f"prefill launches {launches}")
        check(launches["rff_decode_block"] == steps * cfg.num_layers,
              f"decode launches {launches}: {cfg.num_layers} a token expected")
        check(tuple(toks.shape) == (LM_B, LM_NEW)
              and bool((toks < cfg.vocab_size).all()), "generated tokens")
        check(torch.equal(toks, seen.argmax(-1)), "greedy tokens vs logits")

        plain = make_prefill_step(cfg, kernel_mode="ref")(params, {"tokens": tokens})
        plain_seen = path_logits(params, cfg, prompt, toks, kernel_mode="ref")
        cfg32, p32 = replace(cfg, dtype="float32"), as_f32(params)
        del params
        exact = make_prefill_step(cfg32, kernel_mode="ref")(p32, {"tokens": tokens})
        exact_seen = path_logits(p32, cfg32, prompt, toks, kernel_mode="ref")
        v = cfg.vocab_size
        report = {
            "prefill_bf16": lm_budget("prefill", logits[:, :v], plain[:, :v],
                                      exact[:, :v]),
            "decode_bf16": lm_budget("generate", seen[..., :v],
                                     plain_seen[..., :v], exact_seen[..., :v]),
        }
        k32 = make_prefill_step(cfg32)(p32, {"tokens": tokens})
        k32_seen = path_logits(p32, cfg32, prompt, toks)
        report["prefill_f32_kernel_vs_plain"] = hold_rel(
            "f32 prefill", [k32[:, :v]], [exact[:, :v]], LM_F32_TOL)[0]
        report["decode_f32_kernel_vs_plain"] = hold_rel(
            "f32 generate path", [k32_seen[..., :v]], [exact_seen[..., :v]],
            LM_F32_TOL)[0]
    emit({"phase": "lm_server", "arch": cfg.name, "attention": cfg.attention,
          "dtype": cfg.dtype, "B": LM_B, "prefill_S": LM_S,
          "prompt": LM_PROMPT, "new_tokens": LM_NEW,
          "D": cfg.rff_num_features, "params": cfg.param_count(),
          "sample": toks[0, :16].tolist(), "logits": report,
          "tolerance": {"f32_of_max_logit": LM_F32_TOL,
                        "bf16_budget": {"factor": LM_BUDGET,
                                        "floor_of_max_logit": LM_BUDGET_FLOOR}},
          "launches": launches, "seconds": seconds})
    return launches


def phase_lm_gqa_server(seed, device, kernels) -> dict:
    """qwen2-0.5b as published (GQA), bf16: make_prefill_step at B = 4,
    S = 2048 through the flash kernel, against kernel_mode="ref" (the dense
    path) and the f32 copy; then a short generate, which runs no kernel
    (GQA decode is dense attention over the KV cache, as in repro)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.serve.serve_loop import generate
    from repro_torch.train.steps import make_prefill_step

    cfg = get_config(LM_ARCH)
    params, gen = lm_model(cfg, seed + 1, device)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=gen,
                           device=device)
    with torch.inference_mode():
        reset_launches(kernels)
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = path_launches(kernels, ("flash_attention",))
        routes = dict(kernels["flash_attention"].route_launches)
        check(launches["flash_attention"] == cfg.num_layers
              and routes["tensor_core"] == cfg.num_layers,
              f"prefill launches {launches}, routes {routes}")
        before = {name: k.launches for name, k in kernels.items()}
        toks = generate(params, cfg, tokens[:, :LM_PROMPT].contiguous(),
                        steps=LM_GQA_NEW, max_len=LM_PROMPT + LM_GQA_NEW)
        torch.cuda.synchronize()
        check(before == {name: k.launches for name, k in kernels.items()},
              "GQA decode launched a kernel")
        check(tuple(toks.shape) == (LM_B, LM_GQA_NEW)
              and bool((toks < cfg.vocab_size).all()), "generated tokens")
        plain = make_prefill_step(cfg, kernel_mode="ref")(params, {"tokens": tokens})
        cfg32, p32 = replace(cfg, dtype="float32"), as_f32(params)
        del params
        exact = make_prefill_step(cfg32, kernel_mode="ref")(p32, {"tokens": tokens})
        v = cfg.vocab_size
        report = {"prefill_bf16": lm_budget("gqa prefill", logits[:, :v],
                                            plain[:, :v], exact[:, :v])}
        report["prefill_f32_kernel_vs_plain"] = hold_rel(
            "f32 gqa prefill",
            [make_prefill_step(cfg32)(p32, {"tokens": tokens})[:, :v]],
            [exact[:, :v]], LM_F32_TOL)[0]
    emit({"phase": "lm_gqa_server", "arch": cfg.name,
          "attention": cfg.attention, "dtype": cfg.dtype, "B": LM_B,
          "prefill_S": LM_S, "generate_new_tokens": LM_GQA_NEW,
          "sample": toks[0].tolist(), "logits": report, "launches": launches,
          "flash_route_launches": routes, "seconds": seconds})
    return launches


def device_busy(fn, top: int = 6, named: str = "flash", expect=None) -> dict:
    """One run of ``fn()`` under torch.profiler: the device's kernel time
    (the sum of CUDA kernel self times), the kernels launched, those that
    took most and those whose name holds ``named``. The profiled wall time
    is inflated by the profiler's own host cost; the callers set device
    time against an unprofiled wall time.

    ``expect(counts)``, given the launches of each kernel name, says
    whether the profile shows what the caller checks. torch.profiler has
    dropped one layer's kernel records from a prefill's profile late in a
    chip_smoke run on the H100, though the wrappers' launch counts and the
    outputs show that every layer ran: a profile that ``expect`` refuses
    is taken again, up to PROFILE_TRIES times, and the caller checks the
    last one (``profiles`` says how many were taken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        check(bool(kern), "torch.profiler recorded no CUDA kernel")
        names = {e.key: e.count for e in kern}
        if expect is None or expect(names):
            break
    dev = [e.self_device_time_total / 1e3 for e in kern]
    order = sorted(range(len(kern)), key=lambda i: -dev[i])[:top]
    return {"device_ms": sum(dev), "kernel_launches": sum(e.count for e in kern),
            "top": [[kern[i].key[:72], dev[i], kern[i].count] for i in order],
            "named": [[e.key[:72], d, e.count] for e, d in zip(kern, dev)
                      if named in e.key],
            "names": names, "profiles": tries}


def gqa_prefill_profile(layers: int, names: dict) -> bool:
    """Whether a GQA prefill's profile shows flash once a layer, all of it
    on the bf16 route (the tensor-core kernel)."""
    flash = {key: n for key, n in names.items() if "flash" in key}
    return (sum(flash.values()) == layers
            and all("flash_sm90" in key for key in flash))


def rff_prefill_profile(layers: int, names: dict) -> bool:
    """Whether an RFF prefill's profile shows each of kernel 10's launches
    once a layer and no op of its plain version."""
    return (all(sum(n for key, n in names.items() if phase in key) == layers
                for phase in LINEAR_PHASE_KERNELS)
            and not any("tril" in key for key in names))


def phase_lm_times(rng, device) -> dict:
    """Kernels 9-11 at the LM path's shapes: the kernel, its plain version,
    its bound and (flash) SDPA; prefill and decode tokens per second for
    both models; the decode state's bytes.

    Bounds, counting a multiply-add as two operations. Decode block per
    token and head: two projections (4 dh D), per feature the PRF epilogue
    of both rows (10 D: subtract, exp, divide, add, scale), z's update and
    the normalizer (3 D), S's update and the numerator (4 D dv), dv
    divides; f32 CUDA-core rate. Bytes: S and z in and out, q, k, v and
    the output, W and s. Linear attention: the recurrent form's 4 D dv +
    3 D + dv per token and head (the least work of the function), f32;
    bytes: phi_q, phi_k, v in and the output. Flash: 4 dh per kept
    (query, key) pair (Q K^T and P V) and 3 more (subtract, exp, add), at
    the bf16 tensor-core rate for bf16 inputs; bytes: q, k, v and the
    output.
    """
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_state_init, decode_step
    from repro_torch.models import with_rff_attention
    from repro_torch.serve.serve_loop import prefill_tokens
    from repro_torch.train.steps import make_prefill_step

    out = {}
    bh, dh, dfeat, dv = DECODE_SHAPES[0]
    args = decode_inputs(rng, bh, 1, dh, dfeat, dv, "prf", device)
    out["rff_decode_block"] = timed_case(
        lambda m: ops.rff_attention_decode_block(*args, mode=m),
        4 * (2 * bh * (dfeat * dv + dfeat) + bh * (2 * dh + 2 * dv)
             + dh * dfeat + dfeat),
        bh * (4 * dh * dfeat + 13 * dfeat + 4 * dfeat * dv + dv))
    # At T = 1 events around one call read the host (the op and its
    # wrapper take longer to issue than the kernel runs), so ms and
    # plain_ms are device times: the profiler's kernel time over
    # DECODE_CALLS calls, per call. The events' times stay as call_ms.
    row = out["rff_decode_block"]
    row["call_ms"], row["plain_call_ms"] = row.pop("ms"), row.pop("plain_ms")
    row["call_ms_runs"] = row.pop("ms_runs")
    row["plain_call_ms_runs"] = row.pop("plain_ms_runs")
    for key, mode in (("ms", "cuda"), ("plain_ms", "ref")):
        runs = []
        for _ in range(2):
            prof = device_busy(lambda: [ops.rff_attention_decode_block(
                *args, mode=mode) for _ in range(DECODE_CALLS)])
            runs.append(prof["device_ms"] / DECODE_CALLS)
        row[key], row[f"{key}_runs"] = min(runs), runs
        row[f"{key}_top"] = prof["top"]
    big = decode_inputs(rng, bh, 512, dh, dfeat, dv, "prf", device)
    out["rff_decode_block"]["T512"] = {
        "ms": time_ms(lambda: ops.rff_attention_decode_block(*big, mode="cuda"), 5),
        "plain_ms": time_ms(lambda: ops.rff_attention_decode_block(*big, mode="ref"), 3)}
    del big
    bh, slen, dfeat, dv, chunk = LINEAR_SHAPES[0]
    q, k = (positive(rng, bh, slen, dfeat, device=device) for _ in range(2))
    v = f32_tensor(rng, bh, slen, dv, device=device)
    out["rff_linear_attention"] = timed_case(
        lambda m: ops.rff_attention(q, k, v, mode=m, chunk=chunk),
        4 * bh * slen * (2 * dfeat + 2 * dv),
        bh * slen * (4 * dfeat * dv + 3 * dfeat + dv), plain_reps=5)
    del q, k, v
    bh, slen, dh, _ = FLASH_SHAPES[0]
    q, k, v = (f32_tensor(rng, bh, slen, dh, device=device).to(torch.bfloat16)
               for _ in range(3))
    pairs = bh * slen * (slen + 1) // 2
    case = timed_case(lambda m: ops.flash_attention(q, k, v, mode=m),
                      2 * 4 * bh * slen * dh, 0.0, plain_reps=5)
    t_bytes, t_ops = case["bytes"] / HBM_BYTES_PER_S, pairs * (4 * dh + 3) / BF16_OPS_PER_S
    case.update(bound_ms=max(t_bytes, t_ops) * 1e3, ops=pairs * (4 * dh + 3),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    q4, k4, v4 = (x.view(LM_B, bh // LM_B, slen, dh) for x in (q, k, v))
    case["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    out["flash_attention"] = case
    # The f32 route (CUDA cores, IEEE f32) on the same shape, its bound at
    # the f32 rate, and SDPA on f32 inputs.
    q, k, v = (x.float() for x in (q, k, v))
    f32 = timed_case(lambda m: ops.flash_attention(q, k, v, mode=m),
                     4 * 4 * bh * slen * dh, pairs * (4 * dh + 3), plain_reps=5)
    q4, k4, v4 = (x.view(LM_B, bh // LM_B, slen, dh) for x in (q, k, v))
    f32["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    case["routes"] = {"tensor_core": {k_: case[k_] for k_ in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, "cuda_core": {
        k_: f32[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}}
    del q, k, v, q4, k4, v4

    def wall_ms(fn, reps=3) -> float:
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    e2e, state_bytes = {}, {}
    for label, cfg in (("rff", with_rff_attention(get_config(LM_ARCH))),
                       ("gqa", get_config(LM_ARCH))):
        params, gen = lm_model(cfg, 5, device)
        tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_S), generator=gen,
                               device=device)
        with torch.inference_mode():
            step = make_prefill_step(cfg)
            prefill = wall_ms(lambda: step(params, {"tokens": tokens}))
            state = decode_state_init(cfg, LM_B, LM_S, device=device)
            state, _ = prefill_tokens(params, cfg, state, tokens[:, :LM_PROMPT])
            nbytes = sum(t.numel() * t.element_size()
                         for s in state["stack"] for t in s[:2])
            tok = tokens[:, LM_PROMPT]
            for _ in range(2):  # warm-up
                decode_step(params, cfg, state, tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LM_NEW):
                logits, state = decode_step(params, cfg, state, tok)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / LM_NEW
            layers = cfg.num_layers
            if label == "gqa":
                expect = functools.partial(gqa_prefill_profile, layers)
            else:
                expect = functools.partial(rff_prefill_profile, layers)
            busy = {"prefill": device_busy(
                        lambda: step(params, {"tokens": tokens}),
                        expect=expect),
                    "decode_step": device_busy(
                        lambda: decode_step(params, cfg, state, tok))}
        # GQA: the prefill's flash launches are the bf16 route; RFF: each of
        # kernel 10's two launches once a layer, and no plain-version op.
        names = busy["prefill"]["names"]
        shown = {key[:60]: n for key, n in names.items()
                 if any(w in key for w in ("flash", "linear", "tril"))}
        check(expect(names), f"{label} prefill profile: kernels {shown}")
        if label == "rff":
            busy["prefill"]["linear_attention_launches"] = {
                phase: sum(n for key, n in names.items() if phase in key)
                for phase in LINEAR_PHASE_KERNELS}
        for prof in busy.values():
            prof.pop("names")
        busy["prefill"]["busy_share"] = busy["prefill"]["device_ms"] / prefill
        busy["decode_step"]["busy_share"] = (busy["decode_step"]["device_ms"]
                                             / decode_ms)
        e2e[label] = {"prefill_ms": prefill,
                      "prefill_tokens_per_s": LM_B * LM_S / prefill * 1e3,
                      "decode_ms_per_step": decode_ms,
                      "decode_tokens_per_s": LM_B / decode_ms * 1e3,
                      "profile": busy}
        state_bytes[f"{label}_B{LM_B}_ctx{LM_S}"] = nbytes
        del params, state
    cfg = get_config(LM_ARCH)
    kv = decode_state_init(cfg, LM_B, 32768, device=device)
    state_bytes[f"gqa_B{LM_B}_ctx32768"] = sum(
        t.numel() * t.element_size() for s in kv["stack"] for t in s[:2])
    del kv
    emit({"phase": "lm_times", "arch": LM_ARCH, "B": LM_B,
          "kernels": out, "end_to_end": e2e, "decode_state_bytes": state_bytes,
          "shapes": {"decode": DECODE_SHAPES[0], "linear": LINEAR_SHAPES[0],
                     "flash_bf16": FLASH_SHAPES[0]},
          "library_ms": "flash: F.scaled_dot_product_attention(is_causal=True) "
                        "on (B, H, S, dh) bf16; none for kernels 9-10"})
    return out


# Phase 15 (learner_servers): NKLMS at the KLMS serving configuration, and
# the paper's baselines at example 2's settings (section 5.2: d = 5, sigma
# = 5, QKLMS mu = 1 and eps = 5; ALD at repro's f32 nu = 5e-3; capacity 256)
# on model-(9) streams, at the serving bank and chunk.
DICT_D = 5
DICT_HP = {"qklms": dict(sigma=5.0, mu=1.0, quant_eps=5.0, capacity=256),
           "ald": dict(sigma=5.0, nu=5e-3, capacity=256)}
DICT_TICKS = 32  # lockstep ticks a tenant before eviction (two chunks)
DICT_REL = 1e-5  # a sequential readmit against its never-evicted row
# Phase 16 (paper): the kernel path against mode="ref" on the same
# realizations: relative on every figure's tail MSE, and every prior error
# of every run within the f32 serving bound of the largest (RFF-KRLS at
# lam = 1e-4: within BUDGET times the plain path's own distance from a
# float64 run, as the KRLS server); the phase's time.
PAPER_REL = 1e-3
PAPER_MAXREL = SERVER_TOL
PAPER_SECONDS = 120.0


def phase_nklms_server(seed, device, kernels) -> tuple[dict, dict]:
    """make_server("nklms") on the KLMS phase's ragged stream: writes
    through the generic chunk loop, f32 and bf16 reads through the read
    kernel, against the same server with mode="ref" and against
    rff_klms_run(normalized=True) over each tenant's log; then one flush
    timed."""
    from repro_torch.core.klms import rff_klms_run
    from repro_torch.features import rff_map
    from repro_torch.serve import make_server

    fm = rff_map(torch.Generator().manual_seed(seed), D_IN, D_FEAT, SIGMA,
                 device=device)
    hp = dict(feature_map=fm, bank=BANK, chunk=CHUNK, mu=MU, device=device,
              log_capacity=LOG_CAP)
    srv = make_server("nklms", **hp)
    ref_srv = make_server("nklms", mode="ref", **hp)
    rng = np.random.default_rng(seed + 1)  # phase_server's draws, in order
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, D_IN)).astype(np.float32)).to(device)
    rng.normal(size=(4, BANK, D_IN))

    reset_launches(kernels)
    t0 = time.perf_counter()
    mse = []
    for rnd, (tenants, xs, ys) in enumerate(ragged_stream(rng, 6, D_IN)):
        for s in (srv, ref_srv):
            for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                s.submit(t, x, y)
        res = srv.drain() if rnd % 2 else srv.flush()
        ref_res = ref_srv.drain() if rnd % 2 else ref_srv.flush()
        check(sorted(res) == sorted(ref_res), "nklms: served tenants differ")
        got = np.array([e for r in res.values() for _, e in r])
        want = np.array([e for r in ref_res.values() for _, e in r])
        check(np.allclose(got, want, atol=SERVER_TOL, rtol=SERVER_TOL),
              f"nklms flush errors differ by {np.abs(got - want).max():.3g}")
        mse.append(float(np.mean(got ** 2)))
    srv.drain()
    ref_srv.drain()
    reads = {}
    for prec in (None, "bf16"):
        for s in (srv, ref_srv):
            s.snapshot_server.precision = prec
        tol = SERVER_TOL if prec is None else BF16_TOL
        reads[prec] = srv.predict_block(xq)
        hold(f"nklms predict_block {prec}", [reads[prec]],
             [ref_srv.predict_block(xq)], tol)
        for tenant in (0, 1, BANK - 1):
            hold(f"nklms predict tenant {tenant} {prec}",
                 [srv.predict(tenant, xq[tenant])],
                 [ref_srv.predict(tenant, xq[tenant])], tol)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(kernels, ("bank_predict",))

    theta = srv.snapshot.state.theta
    hold("nklms theta vs mode=ref", [theta], [ref_srv.snapshot.state.theta],
         SERVER_TOL)
    log = srv.snapshot_server.log
    busiest = np.argsort(-np.array([log.size(t) for t in range(BANK)]))[:8]
    for t in busiest.tolist():
        check(log.complete(t), f"nklms: tenant {t}'s log overflowed")
        xs, ys = (torch.from_numpy(a).to(device) for a in log.arrays(t))
        run, _ = rff_klms_run(fm, xs, ys, MU, normalized=True)
        hold(f"nklms tenant {t} vs rff_klms_run(normalized=True)",
             [theta[t]], [run.theta], SERVER_TOL)
    check(mse[-1] < mse[0], f"nklms prior MSE did not fall: {mse}")
    bf16_gap = max_err(reads["bf16"], reads[None])
    check(0 < bf16_gap < 2e-2, f"nklms bf16 read contract: gap {bf16_gap}")

    xc = torch.from_numpy(
        rng.normal(size=(BANK, CHUNK, D_IN)).astype(np.float32)).to(device)
    yc, mask = torch.sin(xc[..., 0]), torch.ones(BANK, CHUNK, device=device)
    step, state = srv.queue._chunk_step, srv.queue.state
    flush_ms = time_ms(lambda: step(state, xc, yc, mask), reps=10)
    emit({"phase": "learner_servers", "learner": "nklms", "bank": BANK,
          "d": D_IN, "D": D_FEAT, "chunk": CHUNK, "mu": MU,
          "prior_mse_per_round": mse, "bf16_vs_f32_read_gap": bf16_gap,
          "vs_rff_klms_run_tenants": busiest.tolist(),
          "tolerance": {"vs_ref_server_and_run": SERVER_TOL,
                        "bf16_read": BF16_TOL},
          "flush_ms": flush_ms, "flush_path": "generic chunk loop (no kernel)",
          "launches": launches, "seconds": seconds})
    return launches, {"nklms": flush_ms}


def model9_streams(rng, bank, ticks, d):
    """Per tenant a model-(9) stream (paper section 5.2): y = w0 . x +
    0.1 (w1 . x)^2 + eta, eta ~ N(0, 0.05^2), w0, w1, x ~ N(0, I)."""
    w0, w1 = rng.normal(size=(2, bank, 1, d))
    xs = rng.normal(size=(bank, ticks, d))
    ys = ((xs * w0).sum(-1) + 0.1 * ((xs * w1).sum(-1)) ** 2
          + 0.05 * rng.normal(size=(bank, ticks)))
    return xs.astype(np.float32), ys.astype(np.float32)


def leaf_rel(got, want) -> float:
    """The largest relative distance over a state's floating leaves."""
    return max(rel_norm(g, w) for g, w in zip(got, want)
               if g.is_floating_point())


def phase_dictionary_server(seed, device, learner: str) -> dict:
    """make_server("qklms" | "ald") at B=1024, chunk=16 on model-(9)
    streams: the server against run_stream on the same per-tenant
    sequences (bit for bit), a masked tick (no bit moves), a sequential
    readmit against a never-evicted control (1e-5 relative; whether it is
    bitwise is printed), reads, and one flush timed."""
    from repro_torch.serve import make_server, run_stream

    hp = DICT_HP[learner]
    common = dict(input_dim=DICT_D, bank=BANK, chunk=CHUNK, device=device,
                  **hp)
    srv = make_server(learner, log_capacity=LOG_CAP,
                      rebuild_mode="sequential", **common)
    ctl = make_server(learner, **common)
    rng = np.random.default_rng(seed + 5)
    xs, ys = model9_streams(rng, BANK, DICT_TICKS, DICT_D)
    t0 = time.perf_counter()
    for t in range(DICT_TICKS):
        for b in range(BANK):
            for s in (srv, ctl):
                s.submit(b, xs[b, t], float(ys[b, t]))
    for s in (srv, ctl):
        s.drain()
    want, out = run_stream(learner, None, torch.from_numpy(xs).to(device),
                           torch.from_numpy(ys).to(device),
                           input_dim=DICT_D, **hp)
    for name, g, w in zip(want._fields, srv.queue.state, want):
        check(torch.equal(g, w), f"{learner}: server {name} differs from "
              "run_stream")
    check(all(torch.equal(g, w) for g, w in zip(ctl.queue.state, want)),
          f"{learner}: control server differs from run_stream")
    sizes = srv.queue.state.size

    before = srv.queue.state
    for b in EVICTED:
        srv.submit(b, xs[b, 0], 0.0)
    srv.flush()
    check(all(torch.equal(a[len(EVICTED):], b[len(EVICTED):])
              for a, b in zip(before, srv.queue.state)),
          f"{learner}: a masked tick changed a row")
    for b in EVICTED:  # the control takes the same arrivals
        ctl.submit(b, xs[b, 0], 0.0)
    ctl.flush()

    for b in EVICTED:
        srv.evict(b)
    more_x, more_y = model9_streams(rng, 64, CHUNK, DICT_D)
    for t in range(CHUNK):
        for b in range(64):
            for s in (srv, ctl):
                s.submit(b, more_x[b, t], float(more_y[b, t]))
    for s in (srv, ctl):
        s.drain()
    readmit_ms = readmit_all(srv)
    rows = [tuple(a[b] for a in srv.queue.state) for b in EVICTED]
    ctl_rows = [tuple(a[b] for a in ctl.queue.state) for b in EVICTED]
    rel = [leaf_rel(r, c) for r, c in zip(rows, ctl_rows)]
    bitwise = all(torch.equal(a, b) for r, c in zip(rows, ctl_rows)
                  for a, b in zip(r, c))
    for b, r, c, d in zip(EVICTED, rows, ctl_rows, rel):
        check(torch.equal(r[-2], c[-2]) and torch.equal(r[-1], c[-1]),
              f"{learner}: readmitted tenant {b}'s size or step differs")
        check(d <= DICT_REL, f"{learner}: readmitted tenant {b} is {d:.3g} "
              f"from its never-evicted row (tol {DICT_REL})")
    check(untouched_equal(srv, ctl), f"{learner}: an untouched tenant "
          "differs from the control")
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, DICT_D)).astype(np.float32)).to(device)
    blk = srv.predict_block(xq)
    hold(f"{learner} predict_block vs control", [blk],
         [ctl.predict_block(xq)], SERVER_TOL)
    check(blk.shape == (BANK, Q), f"{learner}: read shape {blk.shape}")
    hold(f"{learner} predict tenant 5", [srv.predict(5, xq[5])], [blk[5]],
         SERVER_TOL)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    xn, yn = model9_streams(rng, BANK, CHUNK, DICT_D)
    xc, yc = torch.from_numpy(xn).to(device), torch.from_numpy(yn).to(device)
    mask = torch.ones(BANK, CHUNK, device=device)
    step, state = srv.queue._chunk_step, srv.queue.state
    flush_ms = time_ms(lambda: step(state, xc, yc, mask), reps=5)
    for b in range(BANK):
        for t in range(CHUNK):
            srv.submit(b, xn[b, t], float(yn[b, t]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    srv.flush()
    torch.cuda.synchronize()
    flush_wall_ms = (time.perf_counter() - t1) * 1e3
    emit({"phase": "learner_servers", "learner": learner, "bank": BANK,
          "d": DICT_D, "chunk": CHUNK, "hp": hp, "ticks": DICT_TICKS,
          "dict_size": {"min": int(sizes.min()), "mean": float(
              sizes.float().mean()), "max": int(sizes.max())},
          "bitwise": {"server_eq_run_stream": True, "masked_tick": True,
                      "untouched_eq_control": True,
                      "readmit_eq_control": bitwise},
          "readmit_rel": rel, "readmit_ms": readmit_ms,
          "tolerance": {"readmit_rel": DICT_REL, "reads": SERVER_TOL},
          "flush_ms": flush_ms, "flush_wall_ms": flush_wall_ms,
          "flush_path": "generic chunk loop (no kernel)",
          "seconds": seconds})
    return {learner: flush_ms}


def phase_paper(seed, device, kernels) -> dict:
    """The paper's figures and table 1 at EXPERIMENTS' settings through
    repro_torch.paper.run_all: every RFF side through its chunk kernel and
    again with mode="ref" on the same realizations (the gate), QKLMS and
    ALD through the generic bank."""
    from repro_torch import paper

    torch.cuda.empty_cache()
    reset_launches(kernels)
    t0 = time.perf_counter()
    res = paper.run_all(seed=seed, device=device, check_ref=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(kernels, ("klms_bank_chunk", "krls_bank_chunk"))
    for name, (us, derived, detail) in res.items():
        emit({"phase": "paper", "figure": name, "us_per_sample": us,
              "derived": derived, **detail})
    for name, (us, derived, detail) in res.items():
        rels = {k: v for k, v in detail.items() if k.startswith("ref_rel_")}
        maxrels = {k: v for k, v in detail.items()
                   if k.startswith("ref_maxrel_")}
        check(len(rels) == len(maxrels) == (name != "table1"),
              f"paper {name}: no ref check")
        for k, v in rels.items():
            check(v <= PAPER_REL, f"paper {name}: {k} = {v:.3g} (kernel vs "
                  f"mode=ref on the tail MSE, tol {PAPER_REL})")
        for k, v in maxrels.items():
            side = k[len("ref_maxrel_"):]
            if f"f64_maxrel_{side}" not in detail:
                check(v <= PAPER_MAXREL, f"paper {name}: {k} = {v:.3g} "
                      f"(kernel vs mode=ref, every prior error, tol "
                      f"{PAPER_MAXREL})")
                continue
            eps = detail[f"f64_maxrel_{side}_plain"]
            kernel = detail[f"f64_maxrel_{side}"]
            check(kernel <= BUDGET * eps + BUDGET_FLOOR,
                  f"paper {name}: {side} kernel {kernel:.3g} from float64, "
                  f"plain {eps:.3g} (budget x{BUDGET})")
            check(v <= (BUDGET + 1) * eps + BUDGET_FLOOR,
                  f"paper {name}: {side} kernel vs plain {v:.3g}, plain "
                  f"{eps:.3g} from float64")
        # Fig. 2b's derived is repro's mean over all runs, which f32 ALD's
        # blown-up runs may leave non-finite; its typical run must not be.
        headline = detail["median_run_ratio"] if name == "fig2b" else derived
        check(np.isfinite(headline), f"paper {name}: {headline}")
    check(seconds <= PAPER_SECONDS, f"paper phase took {seconds:.1f} s "
          f"(limit {PAPER_SECONDS})")
    emit({"phase": "paper", "seconds": seconds, "launches": launches,
          "tolerance": {"kernel_vs_ref_tail_mse_rel": PAPER_REL,
                        "kernel_vs_ref_max_err_rel": PAPER_MAXREL,
                        "krls_f64_budget": [BUDGET, BUDGET_FLOOR]}})
    return launches


# Feature families (phase 17): taylor at the paper's section 6 width, d = 5
# and degree 5, so D = C(10, 5) = 252.
TAYLOR_DEGREE = 5
# The policy tier (phase 18): zipf_bench's middle alpha and its 1:4 bank to
# tenant ratio (benchmarks/zipf_bench.py:47-57) at the serving bank; one
# read of Q queries every READ_EVERY writes. The mode="ref" control runs
# on the first POLICY_REF_PREFIX requests of each policy's stream.
POLICIES = ("lru", "lfu", "cost")
ZIPF_ALPHA, POLICY_TENANTS = 0.9, 4 * BANK
POLICY_WRITES, KRLS_POLICY_WRITES, READ_EVERY = 16384, 4096, 4
POLICY_REF_PREFIX = 8192
AUTO_RESIZE_REQUESTS = 4096
SMI = "not read"  # the card's nvidia-smi name and power limit (main)


def add_launches(total: dict, paths: dict) -> dict:
    for name, n in paths.items():
        total[name] = total.get(name, 0) + n
    return total


def phase_taylor(seed, device, kernels) -> None:
    """The taylor map (no trig form): make_server("klms") and ("krls") at
    d = 5, sigma = 5, degree 5 on phase 5's stream, with reads and
    make_tick, through the generic route on the card. No kernel may
    launch; mode="ref" changes no bit; held against a float64 run: KLMS at
    SERVER_TOL, KRLS by the budget rule."""
    from repro_torch.features import taylor_map
    from repro_torch.serve import make_server, make_tick

    fm = taylor_map(K_D_IN, TAYLOR_DEGREE, K_SIGMA, device=device)
    check(fm.num_features == 252, "taylor at d = 5, degree 5: D != 252")
    fm64 = f64_map(fm)
    rng = np.random.default_rng(seed + 2)
    stream = list(ragged_stream(rng, 6, K_D_IN))
    xq = rng.normal(size=(BANK, Q, K_D_IN)).astype(np.float32)
    tick_x = rng.normal(size=(4, BANK, K_D_IN)).astype(np.float32)
    tick_y = np.sin(tick_x[..., 0]).astype(np.float32)
    report = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    for learner, hp in (("klms", dict(mu=MU)),
                        ("krls", dict(lam=K_LAM, beta=K_BETA))):
        kw = dict(bank=BANK, chunk=CHUNK, device=device, **hp)
        trio = [make_server(learner, feature_map=f, mode=m, **kw)
                for f, m in ((fm, "auto"), (fm, "ref"), (fm64, "ref"))]
        for tenants, xs, ys in stream:
            for srv in trio:
                for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                    srv.submit(t, x, y)
                srv.drain()
        blocks = [srv.predict_block(xq) for srv in trio]
        states = [srv.queue.state for srv in trio]
        ticks = [make_tick(learner, f, mode=m, **hp)
                 for f, m in ((fm, "auto"), (fm, "ref"), (fm64, "ref"))]
        for t in range(tick_x.shape[0]):
            for i, (tick, st) in enumerate(zip(ticks, states)):
                dt = st.theta.dtype
                states[i], _ = tick(
                    st, torch.from_numpy(tick_x[t]).to(device, dt),
                    torch.from_numpy(tick_y[t]).to(device, dt))
        got, plain, exact = (srv.queue.state for srv in trio)
        check(got.theta.device == device and got.pmat.device == device
              if learner == "krls" else got.theta.device == device,
              "taylor state is not on the card")
        check(all(torch.equal(a, b) for a, b in zip(got, plain))
              and torch.equal(blocks[0], blocks[1])
              and all(torch.equal(a, b) for a, b in zip(states[0], states[1])),
              f"taylor {learner}: mode='ref' changed a bit (no kernel runs)")
        check(bool(torch.isfinite(blocks[0]).all())
              and blocks[0].shape == (BANK, Q),
              f"taylor {learner}: reads not finite or misshapen")
        if learner == "klms":
            for name, g, w in (("theta", got.theta, exact.theta),
                               ("predict_block", blocks[0], blocks[2]),
                               ("make_tick theta", states[0].theta,
                                states[2].theta)):
                hold(f"taylor klms {name} vs float64", [g], [w.float()],
                     SERVER_TOL)
            report[learner] = {
                "theta_vs_f64": max_err(got.theta, exact.theta),
                "read_vs_f64": max_err(blocks[0], blocks[2])}
        else:
            report[learner] = {
                "theta": within_budget("taylor theta", got.theta, plain.theta,
                                       exact.theta, normwise),
                "P": within_budget("taylor P", got.pmat, plain.pmat,
                                   exact.pmat, p_rel),
                "predict_block": within_budget("taylor reads", *blocks,
                                               normwise),
                "tick_P": within_budget("taylor make_tick P",
                                        *[s.pmat for s in states], p_rel)}
    torch.cuda.synchronize()
    launched = {name: k.launches for name, k in kernels.items()
                if k.launches}
    check(not launched, f"taylor launched kernels: {launched}")
    emit({"phase": "taylor", "bank": BANK, "d": K_D_IN, "D": fm.num_features,
          "degree": TAYLOR_DEGREE, "sigma": K_SIGMA, "chunk": CHUNK,
          "lam": K_LAM, "beta": K_BETA, "tolerance": {
              "klms_vs_f64": SERVER_TOL, "krls_budget": [BUDGET, BUDGET_FLOOR]},
          "bitwise": {"auto_eq_ref": True}, "launches": 0,
          "report": report, "seconds": time.perf_counter() - t0,
          "card": SMI})


def phase_feature_families(seed, device, kernels) -> dict:
    """Phase 17: qmc through the KLMS main path, gq through the KRLS main
    path, taylor through the generic route, and blocked readmits of the
    qmc KLMS and gq KRLS servers. Every trig part must raise its kernels'
    launches (the path checks); the taylor part none."""
    from repro_torch.features import make_feature_map

    t0 = time.perf_counter()
    for family, d, dfeat, sigma in (("qmc", D_IN, D_FEAT, SIGMA),
                                    ("gq", K_D_IN, K_D_FEAT, K_SIGMA)):
        card = make_feature_map(family, d, dfeat, sigma, device=device)
        host = make_feature_map(family, d, dfeat, sigma, device="cpu")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(card.trig, host.trig)),
              f"{family}: the map built on the card is not the CPU's")
    try:
        make_feature_map("gq", 128, 2048, SIGMA, device=device)
        fail("gq at d = 128 did not raise (the tensor grid's cap)")
    except ValueError as err:
        check("cap" in str(err), f"gq at d = 128: {err}")
    launches: dict = {}
    add_launches(launches, phase_server(seed, device, kernels, family="qmc"))
    add_launches(launches, phase_krls_server(seed, device, kernels,
                                             family="gq"))
    phase_taylor(seed, device, kernels)
    add_launches(launches, phase_replay_server(
        seed, device, kernels, family="qmc", modes=("blocked",)))
    add_launches(launches, phase_krls_replay_server(
        seed, device, kernels, family="gq", modes=("blocked",)))
    emit({"phase": "feature_families", "launches": launches,
          "seconds": time.perf_counter() - t0, "card": SMI})
    return launches


def policy_requests(rng, writes, d):
    """zipf_bench's stream over POLICY_TENANTS tenants: ids with pmf
    1/rank^ZIPF_ALPHA, a read after every READ_EVERY writes; each write a
    tenant's target (an offset plus a ridge function of x)."""
    n = writes + writes // READ_EVERY
    probs = np.arange(1, POLICY_TENANTS + 1, dtype=np.float64) ** -ZIPF_ALPHA
    ids = rng.choice(POLICY_TENANTS, size=n, p=probs / probs.sum())
    dirs = rng.normal(size=(POLICY_TENANTS, d)) / np.sqrt(d)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    ys = (1.0 + 0.5 * np.sin(np.einsum("nd,nd->n", xs, dirs[ids]))
          + 0.05 * rng.normal(size=n)).astype(np.float32)
    pool = rng.normal(size=(64, Q, d)).astype(np.float32)
    return [("read", t, pool[i % len(pool)], None)
            if i % (READ_EVERY + 1) == READ_EVERY
            else ("write", t, xs[i], float(ys[i]))
            for i, t in enumerate(ids.tolist())]


def serve_requests(srv, requests) -> list:
    reads = []
    for kind, tenant, x, y in requests:
        if kind == "read":
            reads.append(srv.predict(tenant, x))
        else:
            srv.submit(tenant, x, y)
    srv.drain()
    return reads


def time_installs(srv) -> list:
    """Wall milliseconds of each install (a replay into a slot), measured
    around the server's rebuild function with a synchronize on each side."""
    inner, ms = srv.snapshot_server, []
    rebuild = inner._rebuild_fn

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rebuild(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    inner._rebuild_fn = timed
    return ms


def same_decisions(name, srv, ctl) -> dict:
    counters = srv.metrics.snapshot()["counters"]
    check(counters == ctl.metrics.snapshot()["counters"],
          f"{name}: counters differ from the control's")
    check(srv.resident == ctl.resident, f"{name}: resident maps differ")
    return counters


def resident_rows(srv):
    slots = sorted(srv.resident.values())
    return srv.queue.state.theta[slots], slots


def reads_close(name, got, want, tol) -> float:
    g, w = torch.cat([r.reshape(-1) for r in got]), torch.cat(
        [r.reshape(-1) for r in want])
    return hold(name, [g], [w.to(g.dtype)], tol) if tol else rel_norm(g, w)


def policy_resize(srv) -> dict:
    """Shrink 1024 -> 512 and grow back: the surviving rows bit for bit."""
    before = {t: (srv.queue.state.theta[s].clone(), int(srv.queue.state.step[s]))
              for t, s in srv.resident.items()}
    out = {}
    for size in (BANK // 2, BANK):
        srv.resize(size)
        check(srv.slots == srv.queue.num_tenants == size, "resize: slots")
        state = srv.queue.state
        for t, s in srv.resident.items():
            check(torch.equal(state.theta[s], before[t][0])
                  and int(state.step[s]) == before[t][1],
                  f"resize to {size}: tenant {t}'s row changed")
        out[size] = srv.policy.occupancy
    check(not bool(srv.queue.state.theta[BANK // 2:].any()),
          "grown rows are not fresh")
    return {"occupancy_after": out, "survivors_bitwise": True}


def phase_policy(seed, device, kernels) -> dict:
    """Phase 18: the bank as a cache. KLMS at the serving configuration
    with a 4096-tenant Zipf stream under lru, lfu and cost (blocked
    installs, kernels 6 and 7), held against the same server with
    sequential installs (identical counters and resident map, rows within
    REPLAY_REL) and, on a prefix, mode="ref"; Server.resize and
    auto_resize; KRLS under lru at the paper's section 6 settings, held
    within the float64 budget. Prints each policy's hit rate, counters,
    write and read p50/p99 and install ms."""
    from repro_torch.serve import make_server

    fm = family_map("rff", seed, D_IN, D_FEAT, SIGMA, device)
    kw = dict(feature_map=fm, bank=BANK, chunk=CHUNK, mu=MU,
              log_capacity=LOG_CAP, size_watermark=CHUNK, device=device)
    rng = np.random.default_rng(seed + 5)
    requests = policy_requests(rng, POLICY_WRITES, D_IN)
    prefix = requests[:POLICY_REF_PREFIX]
    launches: dict = {}
    t_phase = time.perf_counter()
    for policy in POLICIES:
        srv = make_server("klms", policy=policy, rebuild_mode="blocked", **kw)
        ctl = make_server("klms", policy=policy, rebuild_mode="sequential",
                          **kw)
        ref = make_server("klms", policy=policy, rebuild_mode="blocked",
                          mode="ref", **kw)
        install_ms = time_installs(srv)
        reset_launches(kernels)
        t0 = time.perf_counter()
        reads = serve_requests(srv, prefix)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # The kernel server at the prefix's end, for the mode="ref" control.
        at_prefix = (srv.metrics.snapshot()["counters"], srv.resident,
                     srv.queue.state.theta, len(reads))
        reads += serve_requests(srv, requests[len(prefix):])
        torch.cuda.synchronize()
        seconds_all = time.perf_counter() - t0
        add_launches(launches, path_launches(kernels, (
            "klms_bank_chunk", "bank_predict", "rff_features",
            "klms_chunk_elements")))
        snap = srv.metrics.snapshot()
        t1 = time.perf_counter()
        ref_reads = serve_requests(ref, prefix)
        ref_seconds = time.perf_counter() - t1
        check(at_prefix[0] == ref.metrics.snapshot()["counters"]
              and at_prefix[1] == ref.resident,
              f"{policy}: decisions on the prefix differ from mode=ref's")
        hold(f"{policy} theta vs mode=ref", [at_prefix[2]],
             [ref.queue.state.theta], SERVER_TOL)
        vs_ref_reads = reads_close(f"{policy} reads vs mode=ref",
                                   reads[:at_prefix[3]], ref_reads,
                                   SERVER_TOL)
        ctl_reads = serve_requests(ctl, prefix)
        ctl_reads += serve_requests(ctl, requests[len(prefix):])
        counters = same_decisions(f"{policy} vs sequential installs", srv, ctl)
        rows, slots = resident_rows(srv)
        ctl_rows, ctl_slots = resident_rows(ctl)
        vs_ctl = rel_norm(rows, ctl_rows)
        check(slots == ctl_slots and vs_ctl <= REPLAY_REL,
              f"{policy}: resident rows {vs_ctl:.3g} from the sequential "
              f"control (tol {REPLAY_REL})")
        vs_ctl_reads = reads_close(f"{policy} reads vs sequential", reads,
                                   ctl_reads, None)
        check(vs_ctl_reads <= REPLAY_REL,
              f"{policy}: reads {vs_ctl_reads:.3g} from the sequential control")
        check(len(install_ms) == counters.get("readmissions", 0) > 0,
              f"{policy}: installs {len(install_ms)} vs readmissions "
              f"{counters.get('readmissions')}")
        hist = snap["histograms"]
        record = {
            "phase": "policy", "learner": "klms", "policy": policy,
            "bank": BANK, "tenants": POLICY_TENANTS, "alpha": ZIPF_ALPHA,
            "d": D_IN, "D": D_FEAT, "chunk": CHUNK, "Q": Q,
            "writes": POLICY_WRITES, "read_every": READ_EVERY,
            "log_capacity": LOG_CAP, "rebuild_mode": "blocked",
            "hit_rate": srv.hit_rate(), "counters": counters,
            "write_us": {k: hist["latency.write_us"][k]
                         for k in ("p50", "p99", "mean", "count")},
            "read_us": {k: hist["latency.read_us"][k]
                        for k in ("p50", "p99", "mean", "count")},
            "installs": len(install_ms),
            "install_ms": {"p50": float(np.percentile(install_ms, 50)),
                           "p99": float(np.percentile(install_ms, 99)),
                           "mean": float(np.mean(install_ms))},
            "vs_sequential": {"rows_rel": vs_ctl, "reads_rel": vs_ctl_reads},
            "vs_ref_prefix": {"requests": len(prefix),
                              "reads_max_abs": vs_ref_reads,
                              "ref_seconds": ref_seconds},
            "seconds_prefix": seconds, "seconds": seconds_all, "card": SMI}
        if policy == "lru":
            record["resize"] = policy_resize(srv)
        emit(record)
        del srv, ctl, ref
    # auto_resize: lfu (its rejects grow the bank; low occupancy shrinks
    # it), the kernel server against mode="ref" on a short stream.
    auto_kw = dict(kw, policy={"scorer": "lfu", "min_slots": BANK // 8},
                   auto_resize=True, rebuild_mode="blocked")
    auto = [make_server("klms", mode=m, **auto_kw) for m in ("auto", "ref")]
    auto_reads = [serve_requests(s, requests[:AUTO_RESIZE_REQUESTS])
                  for s in auto]
    counters = same_decisions("auto_resize vs mode=ref", *auto)
    check(counters.get("resizes", 0) > 0, "auto_resize did not resize")
    check(auto[0].slots == auto[1].slots, "auto_resize: slots differ")
    hold("auto_resize theta vs mode=ref", [auto[0].queue.state.theta],
         [auto[1].queue.state.theta], SERVER_TOL)
    reads_close("auto_resize reads vs mode=ref", *auto_reads, SERVER_TOL)
    emit({"phase": "policy_auto_resize", "requests": AUTO_RESIZE_REQUESTS,
          "counters": counters, "slots": auto[0].slots, "card": SMI})
    del auto
    launches_krls = phase_policy_krls(seed, device, kernels)
    add_launches(launches, launches_krls)
    emit({"phase": "policy", "seconds": time.perf_counter() - t_phase,
          "launches": launches, "card": SMI})
    return launches


def phase_policy_krls(seed, device, kernels) -> dict:
    """KRLS under lru at the paper's section 6 settings on the first
    KRLS_POLICY_WRITES writes of a Zipf stream: kernel server, plain f32
    and plain float64, the same decisions; resident rows and reads within
    the float64 budget (phase 9's rule)."""
    from repro_torch.serve import make_server

    fm = family_map("rff", seed, K_D_IN, K_D_FEAT, K_SIGMA, device)
    kw = dict(bank=BANK, chunk=CHUNK, lam=K_LAM, beta=K_BETA,
              policy="lru", log_capacity=LOG_CAP, rebuild_mode="blocked",
              size_watermark=CHUNK, device=device)
    trio = [make_server("krls", feature_map=f, mode=m, **kw)
            for f, m in ((fm, "auto"), (fm, "ref"), (f64_map(fm), "ref"))]
    rng = np.random.default_rng(seed + 6)
    requests = policy_requests(rng, KRLS_POLICY_WRITES, K_D_IN)
    install_ms = time_installs(trio[0])
    torch.cuda.empty_cache()
    reset_launches(kernels)
    t0 = time.perf_counter()
    reads = [serve_requests(trio[0], requests)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(kernels, ("krls_bank_chunk", "bank_predict",
                                       "rff_features", "krls_chunk_elements"))
    reads += [serve_requests(s, requests) for s in trio[1:]]
    counters = same_decisions("krls policy vs plain", trio[0], trio[1])
    same_decisions("krls policy vs float64", trio[0], trio[2])
    slots = sorted(trio[0].resident.values())
    states = [s.queue.state for s in trio]
    flat = [torch.cat([r.reshape(-1) for r in rs])[None] for rs in reads]
    budget = {
        "theta": within_budget("krls policy theta",
                               *[st.theta[slots] for st in states], normwise),
        "P": within_budget("krls policy P", *[st.pmat[slots] for st in states],
                           p_rel),
        "reads": within_budget("krls policy reads", *flat, normwise)}
    check(len(install_ms) == counters.get("readmissions", 0) > 0,
          "krls policy: no install")
    hist = trio[0].metrics.snapshot()["histograms"]
    emit({"phase": "policy", "learner": "krls", "policy": "lru",
          "bank": BANK, "tenants": POLICY_TENANTS, "alpha": ZIPF_ALPHA,
          "d": K_D_IN, "D": K_D_FEAT, "lam": K_LAM, "beta": K_BETA,
          "writes": KRLS_POLICY_WRITES, "read_every": READ_EVERY,
          "hit_rate": trio[0].hit_rate(), "counters": counters,
          "write_us": {k: hist["latency.write_us"][k]
                       for k in ("p50", "p99", "mean", "count")},
          "read_us": {k: hist["latency.read_us"][k]
                      for k in ("p50", "p99", "mean", "count")},
          "installs": len(install_ms),
          "install_ms": {"p50": float(np.percentile(install_ms, 50)),
                         "p99": float(np.percentile(install_ms, 99)),
                         "mean": float(np.mean(install_ms))},
          "budget": {"factor": BUDGET, "floor": BUDGET_FLOOR, **budget},
          "launches": launches, "seconds": seconds, "card": SMI})
    return launches


# Phase 19: observability and recovery. The repair grid is the RFF rows of
# benchmarks/recovery_bench.py's REPAIR_GRID at the serving banks (log
# length 256, not 512: the ring holds 256), plus the two kinds that
# tests/test_chaos.py drives and the grid does not.
REPAIR_CASES = (("klms", "nan_state", 32), ("klms", "nan_state", 128),
                ("klms", "nan_state", LOG_CAP), ("nklms", "nan_state", 128),
                ("klms", "log_corrupt", 128), ("krls", "nan_state", 128),
                ("krls", "asym_pmat", 128), ("klms", "drop_flush", 128),
                ("klms", "clock_skew", 128))
RESYM_TOL = 5e-2  # tests/test_chaos.py _RESYM_TOL
SKEW_S, SKEW_BOUND = 2.0, 0.25
TARGET = 1  # the faulted tenant
TAP_FLUSHES = 20  # flushes timed with and without the tap
KILL_WRITES, KILL_CUTS, KRLS_KILL_CUT = 4096, (1537, 3001), 2049
# obs.telemetry's op -> the kernel wrapper whose .launches it must equal.
# One counted element launch is one wrapper call: kernel 7 runs the Gram,
# the solve, T Z and the product in one C call; kernel 8 a prep launch and
# the product tiles (four launches in two C calls); each also launches
# the feature map (kernel 6) once, counted on rff_features.
OP_KERNELS = {"klms_chunk": "klms_bank_chunk", "klms_step": "klms_bank_step",
              "bank_predict": "bank_predict", "krls_chunk": "krls_bank_chunk",
              "krls_step": "krls_bank_step",
              "klms_elements": "klms_chunk_elements",
              "krls_elements": "krls_chunk_elements"}
OBS_KERNELS = ("klms_bank_chunk", "bank_predict", "krls_bank_chunk",
               "rff_features", "klms_chunk_elements", "krls_chunk_elements")


def rows_equal(a, b, skip=()) -> bool:
    """Every slot but ``skip`` bit for bit, across every leaf."""
    keep = [s for s in range(a[0].shape[0]) if s not in skip]
    return all(torch.equal(x[keep], y[keep]) for x, y in zip(a, b))


def flush_ms(srv, xs) -> float:
    """Wall milliseconds of one flush after one arrival for every 16th
    tenant (``xs (B, d)``; the launch is (B, chunk) whatever the backlog),
    with a synchronize on each side."""
    for t in range(0, BANK, 16):
        srv.submit(t, xs[t], 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.flush()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def obs_equivalence(learner, fm, d, hp, seed, device, kernels,
                    workdir) -> dict:
    """(a) A trace=True, probe=True, recovery=True, wal= server against the
    bare one on a phase's ragged stream: every leaf and read bit for bit,
    no degradation event, obs.telemetry's kernel.launches equal to the
    wrappers' .launches rises; flush ms with and without the tap."""
    from repro_torch.obs import probes, telemetry
    from repro_torch.serve import make_server

    kw = dict(feature_map=fm, bank=BANK, chunk=CHUNK, device=device,
              log_capacity=LOG_CAP, rebuild_mode="blocked", **hp)
    plain = make_server(learner, **kw)
    obs = make_server(learner, trace=True, probe=True, recovery=True,
                      wal=str(workdir / f"{learner}_wal.jsonl"), **kw)
    rng = np.random.default_rng(seed + (1 if learner == "klms" else 2))
    before = {k: v.launches for k, v in kernels.items()}
    telemetry.reset()
    submits = 0
    for rnd, (tenants, xs, ys) in enumerate(ragged_stream(rng, 6, d)):
        for srv in (plain, obs):
            for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                srv.submit(t, x, y)
            srv.drain() if rnd % 2 else srv.flush()
        submits += len(tenants)
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, d)).astype(np.float32)).to(device)
    reads = {}
    for prec in (None, "bf16"):
        for srv in (plain, obs):
            srv.snapshot_server.precision = prec
        got, want = obs.predict_block(xq), plain.predict_block(xq)
        check(torch.equal(got, want), f"{learner} {prec} block read differs "
              "with trace and probe on")
        for t in (0, TARGET, BANK - 1):
            check(torch.equal(obs.predict(t, xq[t]), plain.predict(t, xq[t])),
                  f"{learner} {prec} read of tenant {t} differs traced")
        reads[prec] = got
    for srv in (plain, obs):
        srv.snapshot_server.precision = None
    contract = obs.check_read_contract(xq)
    if learner == "klms":
        check(contract <= 2e-2, f"read contract {contract:.3g} > 2e-2")
    check(rows_equal(obs.queue.state, plain.queue.state)
          and rows_equal(obs.snapshot.state, plain.snapshot.state),
          f"{learner}: a traced, probed server's state differs")
    torch.cuda.synchronize()
    reg = telemetry.registry()
    counted = {}
    for op, name in OP_KERNELS.items():
        n = reg.count("kernel.launches", op=op)
        rise = kernels[name].launches - before[name]
        check(n == rise, f"kernel.launches{{op={op}}} {n} != {name}'s "
              f".launches rise {rise}")
        if n:
            counted[op] = n
    stats = obs.probe.last_stats
    check(obs.probe.healthy(), f"{learner}: a healthy server raised "
          f"{[e.to_dict() for e in obs.probe.events]}")
    check(obs.recovery.history == [] and not obs.recovery.quarantined,
          f"{learner}: recovery acted on a healthy server")
    check(len(obs.wal.entries()) == submits, "the WAL lost arrivals")
    spans = obs.tracer.summary()
    tap = probes.stats_tap(obs.queue.state)
    tap_ms = time_ms(lambda: probes.stats_tap(obs.queue.state))
    del tap
    timed = {"plain": [], "probed": []}
    for _ in range(TAP_FLUSHES):
        xs = rng.normal(size=(BANK, d)).astype(np.float32)
        timed["plain"].append(flush_ms(plain, xs))
        timed["probed"].append(flush_ms(obs, xs))
    check(rows_equal(obs.queue.state, plain.queue.state),
          f"{learner}: state differs after the timed flushes")
    obs.wal.close()
    return {"learner": learner, "submits": submits,
            "flushes": obs.queue.flushes,
            "bitwise_leaves_and_reads": True, "healthy_stats": stats,
            "read_contract": contract,
            "kernel_launches": counted,
            "rff_features_launches": kernels["rff_features"].launches
            - before["rff_features"],
            "launch_map": "one op launch = one wrapper call; an element "
                          "call also launches rff_features once (kernel 8: "
                          "four launches in two C calls)",
            "spans": {k: v["count"] + v["events"]
                      for k, v in spans["by_name"].items()},
            "spans_dropped": spans["dropped"],
            "flush_ms_p50": {k: float(np.median(v)) for k, v in timed.items()},
            "tap_ms": tap_ms}


def repair_case(learner, kind, log_len, fm, d, hp, device) -> dict:
    """(c) One fault at the serving bank: detect -> quarantine -> the
    expected rung -> released, twice (cold, warm) where the fault allows,
    against a never-faulted control fed the same arrivals."""
    from repro_torch.core.bank import tenant_row
    from repro_torch.obs.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.serve import make_server
    from repro_torch.serve.snapshot import predict_row

    kw = dict(feature_map=fm, bank=BANK, chunk=CHUNK, policy="lru",
              log_capacity=LOG_CAP, rebuild_mode="blocked", device=device,
              **hp)
    if kind == "clock_skew":
        srv = make_server(learner, probe={"clock_skew": SKEW_BOUND},
                          recovery={"reference_clock": time.monotonic}, **kw)
    else:
        srv = make_server(learner, recovery=True, **kw)
    ctl = make_server(learner, **kw)
    rng = np.random.default_rng(log_len)
    order = np.concatenate([np.full(log_len, TARGET),
                            np.repeat(np.delete(np.arange(BANK), TARGET), 2)])
    rng.shuffle(order)
    warm = [(int(t), rng.normal(size=d).astype(np.float32),
             float(rng.normal())) for t in order]
    for s in (srv, ctl):
        for t, x, y in warm:
            s.submit(t, x, y)
        s.drain()
    fired: list = []
    srv.probe.subscribe(lambda ev: fired.append(time.perf_counter()))
    rec = srv.recovery
    xq1 = torch.from_numpy(rng.normal(size=(Q, d)).astype(np.float32)).to(
        device)
    quarantine_reads = []  # seconds each check took (off the repair time)
    attempt = rec._attempt

    def checked_attempt(ep):
        # While quarantined the tenant reads its last healthy row.
        if not ep.actions:
            h0 = time.perf_counter()
            got = srv.predict(ep.tenant, xq1)
            want = predict_row(rec.healthy_row(ep.tenant).theta, xq1,
                               srv.feature_map)
            check(torch.equal(got, want), f"{learner}/{kind}: a quarantined "
                  "read is not predict_row of the healthy row")
            quarantine_reads.append(time.perf_counter() - h0)
        return attempt(ep)

    rec._attempt = checked_attempt
    episodes = 1 if kind == "log_corrupt" else 2
    timings = []
    for _ in range(episodes):
        fired.clear()
        mark, checks = len(rec.history), len(quarantine_reads)
        inj = FaultInjector(srv, FaultPlan([Fault(
            kind, tenant=TARGET, at_flush=0,
            magnitude=SKEW_S if kind == "clock_skew" else 0.05)])).attach()
        # Other tenants' arrivals drive the faulted flush (a trained row
        # washes a poison out); a dropped flush needs the target's backlog.
        mid = [TARGET, 2] * 4 if kind == "drop_flush" else [0, 2] * 4
        mid = [(t, rng.normal(size=d).astype(np.float32),
                float(rng.normal())) for t in mid]
        for t, x, y in mid:
            srv.submit(t, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.flush()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        srv.drain()
        inj.detach()
        for t, x, y in mid:
            ctl.submit(t, x, y)
        ctl.flush()
        ctl.drain()
        check(bool(fired), f"{learner}/{kind}: the fault was not detected")
        timings.append((fired[0] - t0, t1 - fired[0]
                        - sum(quarantine_reads[checks:])))
        history = [(h.get("action"), h.get("verified"))
                   for h in rec.history[mark:]]
        want = {"clock_skew": [("reclock", None)],
                "log_corrupt": [("rebuild", None), ("reset", True)],
                "asym_pmat": [("resymmetrize", True)]}.get(
                    kind, [("rebuild", True)])
        check(history == want, f"{learner}/{kind}: ladder {history}, "
              f"expected {want}")
        check(not rec.quarantined, f"{learner}/{kind}: not released")
    slot = srv.resident[TARGET]
    check(slot == ctl.resident[TARGET] and srv.resident == ctl.resident,
          f"{learner}/{kind}: residency differs from the control's")
    check(rows_equal(srv.queue.state, ctl.queue.state, skip=(slot,)),
          f"{learner}/{kind}: an untouched tenant's row changed")
    out = {"learner": learner, "fault": kind, "log_len": log_len,
           "action": want[-1][0], "episodes": episodes,
           "quarantine_reads_checked": len(quarantine_reads),
           "detect_us": timings[-1][0] * 1e6,
           "repair_us": timings[-1][1] * 1e6,
           "cold_repair_us": timings[0][1] * 1e6}
    row = tenant_row(srv.queue.state, slot)
    ctl_row = tenant_row(ctl.queue.state, slot)
    if out["action"] == "rebuild":
        xs, ys = ctl.log.arrays(TARGET)
        op = tenant_row(ctl.snapshot_server._rebuild_fn(
            ctl.queue.state, slot, xs, ys), slot)
        check(all(torch.equal(a, b) for a, b in zip(row, op)),
              f"{learner}/{kind}: the rebuilt row is not the operator's "
              "readmit of the same log")
        rel = rel_norm(row[0], ctl_row[0])
        out["rebuilt_vs_trained_rel"] = rel
        if learner != "krls":
            check(rel <= REPLAY_REL, f"{learner}/{kind}: rebuilt row {rel:.3g}"
                  f" from the never-faulted control (tol {REPLAY_REL})")
    elif out["action"] == "reset":
        check(all(torch.equal(a, b) for a, b in zip(row, srv._fresh_row)),
              f"{learner}/{kind}: the reset row is not the fresh row")
    elif out["action"] == "resymmetrize":
        p = row.pmat
        check(torch.equal(p, p.T), "resymmetrized P is not symmetric")
        out["reads_vs_control_rel"] = read_gap(srv, ctl, xq1)
        check(out["reads_vs_control_rel"] < RESYM_TOL,
              f"krls/asym_pmat: reads {out['reads_vs_control_rel']:.3g} "
              f"from the control (tol {RESYM_TOL})")
        # The rung restores P's symmetry, not its value: the symmetric part
        # of the injected delta stays and steers the tenant's next updates.
        # Measured, not held: 2 chunks of the tenant's own arrivals.
        tail = [(TARGET, rng.normal(size=d).astype(np.float32),
                 float(rng.normal())) for _ in range(2 * CHUNK)]
        for s in (srv, ctl):
            for t, x, y in tail:
                s.submit(t, x, y)
            s.drain()
        out["reads_vs_control_rel_after_32_ticks"] = read_gap(srv, ctl, xq1)
    else:
        check(rec.measure_skew() < SKEW_BOUND, "reclock left the skew")
        out["skew_after_s"] = rec.measure_skew()
    check(all(bool(torch.isfinite(a).all()) for a in srv.queue.state),
          f"{learner}/{kind}: non-finite state after the repair")
    return out


def read_gap(srv, ctl, xq) -> float:
    """Max relative gap of the target's reads from the control's."""
    got, want = srv.predict(TARGET, xq), ctl.predict(TARGET, xq)
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def kill_case(learner, fm, writes, cut, hp, device, workdir) -> dict:
    """(d) Kill at a flush: checkpoint at ``cut``, go on to the end; a
    fresh server restores the generation and replays the WAL suffix. Its
    leaves, snapshot, policy state, ledger and reads equal the
    never-killed server's bit for bit."""
    from repro_torch.serve import make_server, restore_checkpoint

    kw = dict(feature_map=fm, bank=BANK, chunk=CHUNK, policy="lru",
              log_capacity=LOG_CAP, size_watermark=CHUNK,
              rebuild_mode="blocked", device=device, **hp)
    tag = f"{learner}_{cut}"
    wal, ckdir = workdir / f"wal_{tag}.jsonl", workdir / f"ckpt_{tag}"
    orig = make_server(learner, wal=str(wal), **kw)
    for _, t, x, y in writes[:cut]:
        orig.submit(t, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = orig.checkpoint(ckdir)
    save_ms = (time.perf_counter() - t0) * 1e3
    for _, t, x, y in writes[cut:]:
        orig.submit(t, x, y)
    orig.drain()
    loaded = make_server(learner, **kw)  # no WAL: the load alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_checkpoint(loaded, ckdir)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    del loaded
    restored = make_server(learner, wal=str(wal), **kw)
    t0 = time.perf_counter()
    info = restore_checkpoint(restored, ckdir)
    restored.drain()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    check(info["replayed"] == len(writes) - cut, "WAL suffix not replayed")
    check(rows_equal(orig.queue.state, restored.queue.state)
          and rows_equal(orig.snapshot.state, restored.snapshot.state),
          f"{tag}: restored leaves differ from the never-killed server")
    check(orig.policy.state_dict() == restored.policy.state_dict(),
          f"{tag}: policy state differs")
    check(orig._expected == restored._expected, f"{tag}: ledger differs")
    xq = torch.from_numpy(np.stack([x for _, _, x, _ in writes[:Q]])).to(
        device)
    hot = sorted(orig.resident)[:8]
    for t in hot:
        check(torch.equal(orig.predict(t, xq), restored.predict(t, xq)),
              f"{tag}: reads of tenant {t} differ")
    nbytes = os.path.getsize(path)
    for s in (orig, restored):
        s.wal.close()
    return {"learner": learner, "writes": len(writes), "cut": cut,
            "replayed": info["replayed"], "save_ms": save_ms,
            "restore_ms": restore_ms, "restore_and_replay_ms": replay_ms,
            "bytes": nbytes, "bitwise": True}


def phase_obs_recovery(seed, device, kernels) -> dict:
    """Phase 19: the observability and recovery tier at the serving
    configurations: (a) traced, probed, self-healing, write-ahead-logged
    servers equal bare ones bit for bit (KLMS serving, KRLS section 6) and
    the dispatch counters equal the kernels' launches; (b) the read
    contract at (1024, 64, 128); (c) the repair grid; (d) kill at a
    flush, restore and WAL replay, bit for bit."""
    import shutil

    workdir = ROOT / "build" / "obs_recovery"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    fm = family_map("rff", seed, D_IN, D_FEAT, SIGMA, device)
    kfm = family_map("rff", seed, K_D_IN, K_D_FEAT, K_SIGMA, device)
    klms_hp, krls_hp = dict(mu=MU), dict(lam=K_LAM, beta=K_BETA)
    t_phase = time.perf_counter()
    reset_launches(kernels)
    equivalence = [
        obs_equivalence("klms", fm, D_IN, klms_hp, seed, device, kernels,
                        workdir),
        obs_equivalence("krls", kfm, K_D_IN, krls_hp, seed, device, kernels,
                        workdir)]
    torch.cuda.empty_cache()
    t_eq = time.perf_counter() - t_phase
    repairs = []
    for learner, kind, log_len in REPAIR_CASES:
        krls = learner == "krls"
        repairs.append(repair_case(
            learner, kind, log_len, kfm if krls else fm,
            K_D_IN if krls else D_IN, krls_hp if krls else klms_hp, device))
    torch.cuda.empty_cache()
    t_rep = time.perf_counter() - t_phase - t_eq
    writes = [r for r in policy_requests(np.random.default_rng(seed + 5),
                                         POLICY_WRITES, D_IN)
              if r[0] == "write"][:KILL_WRITES]
    k_writes = [r for r in policy_requests(np.random.default_rng(seed + 6),
                                           KRLS_POLICY_WRITES, K_D_IN)
                if r[0] == "write"][:KILL_WRITES]
    kills = [kill_case("klms", fm, writes, cut, klms_hp, device, workdir)
             for cut in KILL_CUTS]
    kills.append(kill_case("krls", kfm, k_writes, KRLS_KILL_CUT, krls_hp,
                           device, workdir))
    torch.cuda.synchronize()
    launches = path_launches(kernels, OBS_KERNELS)
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "obs_recovery", "equivalence": equivalence,
          "repairs": repairs, "kill_restore": kills, "launches": launches,
          "seconds": {"equivalence": t_eq, "repairs": t_rep,
                      "kill_restore": seconds - t_eq - t_rep,
                      "total": seconds},
          "card": SMI})
    return launches


# ---------------------------------------------------------------------------
# Phase 20: distribution. Sharded KRLS and diffusion KLMS on
# torch.distributed: ranks spawned as processes (gloo with CUDA tensors, all
# on the one card here; dist_smoke.py runs the same rank body under NCCL,
# one rank a card), the dense and plain controls in this process after the
# ranks have exited.
# ---------------------------------------------------------------------------

DIST_WORLD = 4
# (a) tests/test_krls_sharded.py's shape and tests/test_chunked.py's blocks
DIST_D_IN, DIST_D_FEAT, DIST_SIGMA, DIST_TICKS = 5, 256, 5.0, 600
DIST_LAM, DIST_BETA, DIST_KS = 1e-2, 0.9995, (1, 8, 32)
DIST_STEP_TOL, DIST_BLOCK_TOL = 1e-5, 5e-5  # the reference tests' bounds
# (b) README's "Sharded KRLS memory model" at full width: d = 5, sigma = 5
WIDE_D_FEAT, WIDE_TICKS, WIDE_LAMS = 32768, 256, (1e-2, 1e-4)
# (c) benchmarks/krls_shard_bench.py's grid (d = 8, sigma = 2)
GRID_D_IN, GRID_SIGMA, GRID_D_FEATS, GRID_TICKS = 8, 2.0, (256, 512, 1024), 32
GRID_WARM = 2  # untimed ticks first
# (d) diffusion at four nodes: tests/test_distributed.py's configuration
# (D = 100, mu = 0.5, 600 a node; combine every tick, never, int8) and
# example 1's width (configs/paper_rff.py:28: D = 1000, mu = 1.0, 5000
# samples a node of model (7)), combining every 50 ticks (a gloo round of
# four ranks on one host costs 6-10 ms there); (combine_every, compress)
# runs.
DIFFUSION = {
    "reference": dict(dfeat=100, mu=0.5, ticks=600, data="wiener",
                      runs=((1, 0), (10**9, 0), (1, 1))),
    "example1": dict(dfeat=1000, mu=1.0, ticks=5000, data="expansion",
                     runs=((50, 0),)),
}
DIFF_SIGMA, DIFF_TOL = 5.0, 1e-4
# An int8 run is held tick by tick over its first DIFF_HEAD combines (a
# prefix run's theta, and the errors that read them): past those, a message
# one ulp apart can round one int8 level apart and the runs part.
DIFF_HEAD = 3
DIST_DIR = ROOT / "build" / "dist"
DIST_KERNELS = ("rff_features", "bank_predict", "klms_bank_chunk")


def dist_inputs(seed: int) -> dict:
    """Every part's feature maps and streams as numpy arrays, drawn on the
    CPU from ``seed`` (the ranks and the controls read the same file)."""
    from repro_torch.core.rff import sample_rff
    from repro_torch.data.synthetic import (
        gen_kernel_expansion,
        gen_nonlinear_wiener,
    )

    g = torch.Generator().manual_seed(seed + 20)
    out = {}

    def draw(key, d, dfeat, sigma):
        rff = sample_rff(g, d, dfeat, sigma, device="cpu")
        out[f"{key}_omega"] = rff.omega.numpy()
        out[f"{key}_bias"] = rff.bias.numpy()

    def stream(key, n, d, shape):
        xs, ys = gen_nonlinear_wiener(g, num_samples=n, input_dim=d)
        out[f"{key}_xs"] = xs.numpy().reshape(*shape, d)
        out[f"{key}_ys"] = ys.numpy().reshape(shape)

    draw("small", DIST_D_IN, DIST_D_FEAT, DIST_SIGMA)
    stream("small", DIST_TICKS, DIST_D_IN, (DIST_TICKS,))
    out["small_xq"] = np.random.default_rng(seed + 21).normal(
        size=(8, DIST_D_IN)).astype(np.float32)
    draw("wide", DIST_D_IN, WIDE_D_FEAT, DIST_SIGMA)
    stream("wide", WIDE_TICKS, DIST_D_IN, (WIDE_TICKS,))
    for dfeat in GRID_D_FEATS:
        draw(f"grid{dfeat}", GRID_D_IN, dfeat, GRID_SIGMA)
        stream(f"grid{dfeat}", GRID_TICKS + GRID_WARM, GRID_D_IN,
               (GRID_TICKS + GRID_WARM,))
    for name, cfg in DIFFUSION.items():
        draw(f"diff_{name}", DIST_D_IN, cfg["dfeat"], DIFF_SIGMA)
        n, key = cfg["ticks"] * DIST_WORLD, f"diff_{name}"
        if cfg["data"] == "wiener":
            stream(key, n, DIST_D_IN, (DIST_WORLD, cfg["ticks"]))
        else:
            data = gen_kernel_expansion(g, num_samples=n, sigma=DIFF_SIGMA)
            out[f"{key}_xs"] = data.xs.numpy().reshape(
                DIST_WORLD, cfg["ticks"], DIST_D_IN)
            out[f"{key}_ys"] = data.ys.numpy().reshape(
                DIST_WORLD, cfg["ticks"])
    return out


def _sync_s(t0: float) -> float:
    """Seconds since ``t0`` once the card has finished."""
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dist_work(inp: dict, parts: str, cpu_group=None) -> dict:
    """One rank's share of phase 20 (every rank calls it, SPMD) on the
    initialized process group, on this rank's current card. ``parts``:
    "a" sharded KRLS at the test shape (per tick and blocks of 8 and 32, a
    predict), "b" at D = 32768 (lam 1e-2 and 1e-4; ms a tick, all_reduce
    ms a tick, peak bytes a rank), "c" the shard bench's grid, "d"
    diffusion. Host copies cross ranks on ``cpu_group`` (None: the default
    group, which must then be gloo). Returns the results, the same on
    every rank."""
    t_enter = time.perf_counter()
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core.distributed import diffusion_klms_run
    from repro_torch.core.krls import (
        make_sharded_krls_predict,
        sharded_krls_run,
    )
    from repro_torch.kernels.rff_features import rff_features_cuda
    from repro_torch.kernels.rff_klms_step import rff_klms_bank_chunk_cuda
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda
    from repro_torch.launch.mesh import make_krls_mesh

    wrappers = dict(zip(DIST_KERNELS, (rff_features_cuda,
                                       rff_bank_predict_cuda,
                                       rff_klms_bank_chunk_cuda)))
    mesh = make_krls_mesh(device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    calls, timed, ar_s = [0], [False], [0.0]
    inner = dist.all_reduce

    def all_reduce(*args, **kw):
        calls[0] += 1
        if not timed[0]:
            return inner(*args, **kw)
        _sync_s(0.0)  # the card idle when the collective starts
        t0 = time.perf_counter()
        res = inner(*args, **kw)
        ar_s[0] += _sync_s(t0)
        return res

    def tf(key):
        return convert.trig_features(inp[f"{key}_omega"], inp[f"{key}_bias"],
                                     device=dev)

    def stream(key):
        return (torch.from_numpy(inp[f"{key}_xs"]).to(dev),
                torch.from_numpy(inp[f"{key}_ys"]).to(dev))

    out, per_rank, seconds = {}, {}, {}
    # one collective before any timing: NCCL sets up its communicator on
    # the first call (seconds), which no tick should be charged
    inner(torch.zeros(1, device=dev), group=mesh.get_group(0))
    seconds["setup"] = _sync_s(t_enter)
    dist.all_reduce = all_reduce
    for w in wrappers.values():
        w.launches = 0
    try:
        if "a" in parts:
            t_part = time.perf_counter()
            fm, (xs, ys) = tf("small"), stream("small")
            for k in DIST_KS[:2]:  # warm-up: the first launches and rounds
                sharded_krls_run(mesh, fm, xs[:8], ys[:8], lam=DIST_LAM,
                                 beta=DIST_BETA, combine_every=k)
            for k in DIST_KS:
                before, t0 = calls[0], time.perf_counter()
                state, o = sharded_krls_run(mesh, fm, xs, ys, lam=DIST_LAM,
                                            beta=DIST_BETA, combine_every=k)
                out[f"a_ms_tick_k{k}"] = _sync_s(t0) / DIST_TICKS * 1e3
                out[f"a_calls_k{k}"] = calls[0] - before
                out[f"a_pred_k{k}"] = o.prediction.cpu().numpy()
                if k == 1:
                    predict = make_sharded_krls_predict(mesh, fm)
                    out["a_predict"] = predict(
                        state, torch.from_numpy(inp["small_xq"]).to(dev)
                    ).cpu().numpy()
                    theta, pmat, step = convert.gather_rls_state(state,
                                                                 cpu_group)
                    out["a_theta"], out["a_step"] = theta, int(step)
                    out["a_p_symmetric"] = bool(np.array_equal(pmat, pmat.T))
                del state
            seconds["a"] = time.perf_counter() - t_part
        if "b" in parts:
            t_part = time.perf_counter()
            fm, (xs, ys) = tf("wide"), stream("wide")
            for i, lam in enumerate(WIDE_LAMS):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                timed[0], ar_s[0] = i == 1, 0.0
                before, t0 = calls[0], time.perf_counter()
                state, o = sharded_krls_run(mesh, fm, xs, ys, lam=lam,
                                            beta=DIST_BETA)
                out[f"b_ms_tick_lam{i}"] = _sync_s(t0) / WIDE_TICKS * 1e3
                timed[0] = False
                out[f"b_calls_lam{i}"] = calls[0] - before
                out[f"b_pred_lam{i}"] = o.prediction.cpu().numpy()
                per_rank[f"b_peak_bytes_lam{i}"] = (
                    torch.cuda.max_memory_allocated() - base)
                del state, o
            out["b_all_reduce_ms_tick"] = ar_s[0] / WIDE_TICKS * 1e3
            torch.cuda.empty_cache()
            seconds["b"] = time.perf_counter() - t_part
        if "c" in parts:
            t_part = time.perf_counter()
            for dfeat in GRID_D_FEATS:
                fm, (xs, ys) = tf(f"grid{dfeat}"), stream(f"grid{dfeat}")
                sharded_krls_run(mesh, fm, xs[:GRID_WARM], ys[:GRID_WARM],
                                 lam=DIST_LAM, beta=DIST_BETA)
                t0 = time.perf_counter()
                sharded_krls_run(mesh, fm, xs[GRID_WARM:], ys[GRID_WARM:],
                                 lam=DIST_LAM, beta=DIST_BETA)
                out[f"c_ms_tick_{dfeat}"] = _sync_s(t0) / GRID_TICKS * 1e3
            seconds["c"] = time.perf_counter() - t_part
        if "d" in parts:
            t_part = time.perf_counter()
            for name, cfg in DIFFUSION.items():
                fm = tf(f"diff_{name}")
                xs, ys = stream(f"diff_{name}")
                for j, (every, compress) in enumerate(cfg["runs"]):
                    before, t0 = calls[0], time.perf_counter()
                    theta, errs = diffusion_klms_run(
                        mesh, "shard", fm, xs, ys, cfg["mu"], every,
                        bool(compress))
                    key = f"d_{name}_{j}"
                    out[f"{key}_ms_tick"] = (_sync_s(t0) / cfg["ticks"]
                                             * 1e3)
                    out[f"{key}_calls"] = calls[0] - before
                    out[f"{key}_theta"] = convert.gather(theta, cpu_group)
                    out[f"{key}_errs"] = convert.gather(errs, cpu_group)
                    if compress:  # the combines before the first level flip
                        theta, _ = diffusion_klms_run(
                            mesh, "shard", fm, xs[:, :DIFF_HEAD],
                            ys[:, :DIFF_HEAD], cfg["mu"], every, True)
                        out[f"{key}_head_theta"] = convert.gather(theta,
                                                                  cpu_group)
            seconds["d"] = time.perf_counter() - t_part
    finally:
        dist.all_reduce = inner
    per_rank.update({f"launches_{n}": w.launches
                     for n, w in wrappers.items()})
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, per_rank, group=cpu_group)
    for key in per_rank:
        out[key] = [r[key] for r in gathered]
    out["world"], out["backend"] = dist.get_world_size(), dist.get_backend()
    out["seconds"] = seconds
    return out


def dist_rank(rank: int, world: int, init_method: str, parts: str,
              inp_path: str, out_path: str) -> None:
    """A spawned rank of phase 20: gloo with CUDA tensors, every rank on
    the one card; rank 0 saves the results and when it entered and left."""
    entered = time.time()
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        out = dist_work(dict(np.load(inp_path)), parts)
        out["stamps"] = (entered, time.time())
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def diffusion_plain(fm, xs, ys, mu, every, compress):
    """Diffusion as one process's plain PyTorch: the nodes as a bank
    through the chunk's plain version, the combine a mean over rows."""
    from repro_torch.core.distributed import dequantize_int8, quantize_int8
    from repro_torch.kernels import ref

    nodes, n, _ = xs.shape
    theta = xs.new_zeros((nodes, fm.num_features))
    comp = torch.zeros_like(theta)
    errs = []
    for start in range(0, n, every):
        stop = min(start + every, n)
        theta, _, e = ref.rff_klms_bank_chunk_ref(
            theta, xs[:, start:stop], ys[:, start:stop], fm.omega, fm.bias,
            mu, None, fm.scale)
        errs.append(e)
        if stop % every:
            continue
        if compress:
            msg = theta + comp
            deq = torch.stack([dequantize_int8(*quantize_int8(m))
                               for m in msg])
            comp = msg - deq
            theta = deq
        theta = (theta.sum(0, keepdim=True) / nodes).expand(nodes, -1)
        theta = theta.contiguous()
    return theta, torch.cat(errs, 1)


def _tail_mse(errs) -> float:
    return float(np.mean(np.asarray(errs)[:, -100:] ** 2))


def dist_controls(inp: dict, res: dict, device, parts: str) -> dict:
    """Hold the ranks' results (``dist_work``) against dense and plain
    runs on ``device``, after the ranks have exited. Returns the figures
    to print; any miss fails."""
    from repro_torch import convert
    from repro_torch.core.krls import rff_krls_run
    from repro_torch.launch.sharding import krls_shard_bytes

    def tf(key, dtype=torch.float32):
        fm = convert.trig_features(inp[f"{key}_omega"], inp[f"{key}_bias"],
                                   device=device)
        return type(fm)(*(a.to(dtype) for a in fm))

    def stream(key, dtype=torch.float32):
        return (torch.from_numpy(inp[f"{key}_xs"]).to(device, dtype),
                torch.from_numpy(inp[f"{key}_ys"]).to(device, dtype))

    def dense(key, lam, dtype=torch.float32):
        state, o = rff_krls_run(tf(key, dtype), *stream(key, dtype),
                                lam=lam, beta=DIST_BETA)
        return state, o.prediction.double().cpu().numpy()

    def dense_exact(key, lam):
        """The float64 dense filter, plain and in place: one product and
        one ``P <- (P - inv pz pz^T) / beta`` pass a tick (rff_krls_run's
        allocating, symmetrizing passes are ~4x the traffic at D = 32768,
        where P is 8 GiB)."""
        fm = tf(key, torch.float64)
        xs, ys = stream(key, torch.float64)
        zs = torch.cos(xs @ fm.omega + fm.bias) * fm.scale
        pmat = torch.eye(fm.num_features, dtype=torch.float64,
                         device=device).div_(lam)
        theta = torch.zeros_like(zs[0])
        preds = []
        for z, y in zip(zs, ys):
            pz = torch.mv(pmat, z)
            y_hat = theta @ z
            inv = 1.0 / (DIST_BETA + z @ pz)
            theta += ((y - y_hat) * inv) * pz
            pmat.addr_(pz * (-inv / DIST_BETA), pz, beta=1.0 / DIST_BETA)
            preds.append(y_hat)
        del pmat
        return torch.stack(preds).cpu().numpy()

    def diff(a, b) -> float:
        return float(np.max(np.abs(np.asarray(a, np.float64)
                                    - np.asarray(b, np.float64))))

    figures, seconds = {}, {}
    t_part = time.perf_counter()
    if "a" in parts:
        state, want = dense("small", DIST_LAM)
        got = {k: res[f"a_pred_k{k}"] for k in DIST_KS}
        errs = {f"k{k}_vs_dense": diff(got[k], want) for k in DIST_KS}
        errs.update({f"k{k}_vs_per_tick": diff(got[k], got[1])
                     for k in DIST_KS[1:]})
        check(errs["k1_vs_dense"] <= DIST_STEP_TOL,
              f"sharded krls per tick {errs['k1_vs_dense']:.3g} from dense")
        for k in DIST_KS[1:]:
            for key in (f"k{k}_vs_dense", f"k{k}_vs_per_tick"):
                check(errs[key] <= DIST_BLOCK_TOL,
                      f"sharded krls {key} {errs[key]:.3g}")
        calls = {k: res[f"a_calls_k{k}"] for k in DIST_KS}
        check(calls == {k: -(-DIST_TICKS // k) for k in DIST_KS},
              f"all_reduces a run: {calls} (one a tick, one a block)")
        check(res["a_p_symmetric"] and res["a_step"] == DIST_TICKS,
              "the gathered P is not bitwise symmetric, or the step is off")
        z = convert.trig_features(inp["small_omega"], inp["small_bias"],
                                  device=device)
        xq = torch.from_numpy(inp["small_xq"]).to(device)
        read = (torch.cos(xq @ z.omega + z.bias) * z.scale) @ state.theta
        errs["predict_vs_dense"] = diff(res["a_predict"], read.cpu())
        errs["theta_vs_dense"] = diff(res["a_theta"], state.theta.cpu())
        check(errs["predict_vs_dense"] <= SERVER_TOL,
              f"sharded predict {errs['predict_vs_dense']:.3g} from dense")
        seconds["a"] = time.perf_counter() - t_part
        figures["a"] = {"errors": errs, "all_reduces": calls,
                        "ms_tick": {k: res[f"a_ms_tick_k{k}"]
                                    for k in DIST_KS}}
        del state
    t_part = time.perf_counter()
    if "b" in parts:
        model = krls_shard_bytes(WIDE_D_FEAT, res["world"], DIST_D_IN)
        b = {"bytes_model": model}
        for i, lam in enumerate(WIDE_LAMS):
            torch.cuda.empty_cache()
            exact = dense_exact("wide", lam)
            got = res[f"b_pred_lam{i}"]
            check(bool(np.isfinite(got).all()) and got.shape == exact.shape,
                  f"sharded krls at D = {WIDE_D_FEAT}: output not finite")
            rec = {"vs_dense_f64": diff(got, exact),
                   "ms_tick": res[f"b_ms_tick_lam{i}"],
                   "all_reduces": res[f"b_calls_lam{i}"],
                   "peak_bytes_a_rank": res[f"b_peak_bytes_lam{i}"]}
            check(rec["all_reduces"] == WIDE_TICKS,
                  f"{rec['all_reduces']} all_reduces in {WIDE_TICKS} ticks")
            # the state's P_l and one P_l-sized scratch, nothing else big
            check(max(rec["peak_bytes_a_rank"])
                  <= 2 * model["p_block_bytes"] + 2 ** 24,
                  f"peak bytes a rank {rec['peak_bytes_a_rank']}, P block "
                  f"{model['p_block_bytes']}")
            if lam == 1e-4:
                torch.cuda.empty_cache()
                _, want = dense("wide", lam)
                eps = diff(want, exact)
                rec.update(vs_dense_f32=diff(got, want), dense_f32_vs_f64=eps)
                check(rec["vs_dense_f64"] <= BUDGET * eps + BUDGET_FLOOR,
                      f"sharded krls at lam = 1e-4: {rec['vs_dense_f64']:.3g} "
                      f"from float64, dense f32 {eps:.3g} (budget x{BUDGET})")
            else:
                check(rec["vs_dense_f64"] <= SERVER_TOL,
                      f"sharded krls at D = {WIDE_D_FEAT}, lam = {lam}: "
                      f"{rec['vs_dense_f64']:.3g} from float64 dense")
            b[f"lam{lam:g}"] = rec
        b["all_reduce_ms_tick"] = res["b_all_reduce_ms_tick"]
        seconds["b"] = time.perf_counter() - t_part
        figures["b"] = b
        torch.cuda.empty_cache()
    t_part = time.perf_counter()
    if "c" in parts:
        grid = {}
        for dfeat in GRID_D_FEATS:
            fm, (xs, ys) = tf(f"grid{dfeat}"), stream(f"grid{dfeat}")
            rff_krls_run(fm, xs[:GRID_WARM], ys[:GRID_WARM], lam=DIST_LAM,
                         beta=DIST_BETA)
            t0 = time.perf_counter()
            rff_krls_run(fm, xs[GRID_WARM:], ys[GRID_WARM:], lam=DIST_LAM,
                         beta=DIST_BETA)
            grid[dfeat] = {"sharded_ms_tick": res[f"c_ms_tick_{dfeat}"],
                           "dense_ms_tick": _sync_s(t0)
                           / GRID_TICKS * 1e3}
        seconds["c"] = time.perf_counter() - t_part
        figures["c"] = grid
    t_part = time.perf_counter()
    if "d" in parts:
        d = {}
        for name, cfg in DIFFUSION.items():
            fm = tf(f"diff_{name}")
            xs, ys = stream(f"diff_{name}")
            mse, uncompressed = [], {}
            for j, (every, compress) in enumerate(cfg["runs"]):
                key = f"d_{name}_{j}"
                theta, errs = res[f"{key}_theta"], res[f"{key}_errs"]
                p_theta, p_errs = diffusion_plain(fm, xs, ys, cfg["mu"],
                                                  every, compress)
                p_theta, p_errs = p_theta.cpu().numpy(), p_errs.cpu().numpy()
                check(theta.shape == p_theta.shape
                      and errs.shape == p_errs.shape
                      and bool(np.isfinite(errs).all()),
                      f"diffusion {key}: shapes or non-finite errors")
                rec = {"first_tick": diff(errs[:, 0], p_errs[:, 0]),
                       "errs": diff(errs, p_errs),
                       "theta": diff(theta, p_theta),
                       "spread": diff(theta, theta[0:1]),
                       "tail_mse": _tail_mse(errs),
                       "plain_tail_mse": _tail_mse(p_errs),
                       "ms_tick": res[f"{key}_ms_tick"],
                       "all_reduces": res[f"{key}_calls"]}
                mse.append(rec["tail_mse"])
                check(rec["first_tick"] <= DIST_STEP_TOL,
                      f"diffusion {key}: first tick {rec['first_tick']:.3g}")
                if compress:
                    # tick by tick over the first DIFF_HEAD combines (past
                    # them an int8 level can flip), apart from the same run
                    # uncompressed, and by the tail MSE over the stream
                    head = DIFF_HEAD + 1  # tick DIFF_HEAD reads the last
                    p_head, _ = diffusion_plain(
                        fm, xs[:, :DIFF_HEAD], ys[:, :DIFF_HEAD], cfg["mu"],
                        every, compress)
                    rec.update(
                        head_errs=diff(errs[:, :head], p_errs[:, :head]),
                        head_theta=diff(res[f"{key}_head_theta"],
                                        p_head.cpu()),
                        head_vs_uncompressed=diff(
                            errs[:, :head], uncompressed[every][:, :head]))
                    check(rec["head_errs"] <= DIST_STEP_TOL
                          and rec["head_theta"] <= DIST_STEP_TOL,
                          f"diffusion {key}: first {DIFF_HEAD} combines {rec}")
                    check(rec["head_vs_uncompressed"] > 10 * DIST_STEP_TOL,
                          f"diffusion {key}: int8 run as the uncompressed "
                          f"one {rec}")
                    check(abs(rec["tail_mse"] / rec["plain_tail_mse"] - 1)
                          <= 1e-2, f"diffusion {key}: tail MSE {rec}")
                else:
                    uncompressed[every] = errs
                    check(rec["errs"] <= DIFF_TOL and rec["theta"] <= DIFF_TOL,
                          f"diffusion {key}: {rec} (tol {DIFF_TOL})")
                if cfg["ticks"] % every == 0:
                    check(rec["spread"] == 0.0,
                          f"diffusion {key}: nodes apart by {rec['spread']}")
                check(rec["all_reduces"] == cfg["ticks"] // every,
                      f"diffusion {key}: {rec['all_reduces']} all_reduces")
                d[key] = rec
            if len(mse) == 3:
                check(mse[0] <= mse[1] * 1.05 and mse[2] <= mse[0] * 1.5,
                      f"diffusion tail MSEs every/never/int8 {mse}")
        seconds["d"] = time.perf_counter() - t_part
        figures["d"] = d
    figures["seconds"] = seconds
    return figures


SHIM_NAMES = (
    "make_bank_server", "serve_bank_stream", "reset_tenants",
    "make_krls_bank_server", "serve_krls_bank_stream", "reset_krls_tenants",
    "make_chunked_bank_server", "make_chunked_krls_bank_server",
    "klms_micro_batch_queue", "krls_micro_batch_queue",
    "klms_snapshot_server", "krls_snapshot_server",
)
SHIM_BANK, SHIM_TICKS = 64, 9


def _leaves(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _leaves(obj[k])]
    if isinstance(obj, (float, int, np.floating)):
        return [torch.tensor(float(obj), dtype=torch.float64)]
    return []


def shim_case(name: str, seed: int, device) -> tuple:
    """``name`` and the facade call it wraps, once each on the same
    inputs: the KLMS serving map (d = 128, D = 2048) for the KLMS names,
    the paper's section 6 map for the KRLS ones, a bank of 64."""
    import warnings

    from repro_torch.core.bank import klms_bank_init, krls_bank_init
    from repro_torch.serve import api, bank_loop, queue, snapshot

    krls = "krls" in name
    d, dfeat, sigma = ((K_D_IN, K_D_FEAT, K_SIGMA) if krls
                       else (D_IN, D_FEAT, SIGMA))
    fm = family_map("rff", seed, d, dfeat, sigma, device)
    hp = dict(lam=K_LAM, beta=K_BETA) if krls else dict(mu=MU)
    rng = np.random.default_rng(seed + 30)
    xs = torch.tensor(rng.normal(size=(SHIM_BANK, SHIM_TICKS, d)),
                      dtype=torch.float32, device=device)
    ys = torch.sin(xs[..., 0])
    x0, y0 = xs[:, 0].contiguous(), ys[:, 0].contiguous()
    mask = torch.tensor(rng.random((SHIM_BANK, SHIM_TICKS)) < 0.7,
                        dtype=torch.float32, device=device)
    state = krls_bank_init(fm, SHIM_BANK, K_LAM) if krls else (
        klms_bank_init(fm, SHIM_BANK))
    tenants = rng.integers(0, SHIM_BANK, size=256)
    sx = rng.normal(size=(256, d)).astype(np.float32)
    sy = np.sin(sx[:, 0]).astype(np.float32)
    learner = "krls" if krls else "klms"
    rate = {"beta": K_BETA} if krls else {"mu": MU}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if name in ("make_bank_server", "make_krls_bank_server"):
            return (getattr(bank_loop, name)(fm, *rate.values())(
                        state, x0, y0),
                    api.make_tick(learner, fm, **rate)(state, x0, y0))
        if name in ("serve_bank_stream", "serve_krls_bank_stream"):
            args = (K_LAM, K_BETA) if krls else (MU,)
            return (getattr(bank_loop, name)(fm, xs, ys, *args, chunk=4),
                    api.run_stream(learner, fm, xs, ys, chunk=4, **hp))
        if name in ("reset_tenants", "reset_krls_tenants"):
            state, _ = api.run_stream(learner, fm, xs, ys, **hp)
            args = (K_LAM,) if krls else ()
            return (getattr(bank_loop, name)(state, [1, 3], *args),
                    api.reset_slots(state, [1, 3], learner=learner,
                                    **({"lam": K_LAM} if krls else {})))
        if name.startswith("make_chunked"):
            return (getattr(queue, name)(fm, *rate.values())(
                        state, xs, ys, mask),
                    api.make_chunk_step(learner, fm, **rate)(
                        state, xs, ys, mask))
        if name.endswith("micro_batch_queue"):
            shim = getattr(queue, name)(fm, SHIM_BANK, chunk=4,
                                        device=device, **hp)
            facade = api.make_queue(learner, fm, SHIM_BANK, chunk=4,
                                    device=device, **hp)
            return tuple((_serve(q, tenants, sx, sy), q.state)
                         for q in (shim, facade))
        shim = getattr(snapshot, name)(fm, SHIM_BANK, chunk=4, device=device,
                                       log_capacity=64, **hp)
        facade = api.make_server(learner, feature_map=fm, bank=SHIM_BANK,
                                 chunk=4, device=device, log_capacity=64,
                                 **hp)
        out = []
        for srv in (shim, facade):
            drained = _serve(srv, tenants, sx, sy)
            srv.evict(0)
            _serve(srv, tenants[:16], sx[:16], sy[:16])
            srv.readmit(0)
            out.append((drained, srv.snapshot.state,
                        srv.predict_block(xs[:, :3].cpu().numpy())))
        return tuple(out)


def _serve(srv, tenants, xs, ys):
    for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
        srv.submit(t, x, y)
    return srv.drain()


def phase_shims(seed, device, kernels) -> dict:
    """Phase 20 (e): each deprecated serve name once on the card, its
    result bit for bit its facade call's."""
    reset_launches(kernels)
    for name in SHIM_NAMES:
        shim, facade = shim_case(name, seed, device)
        got, want = _leaves(shim), _leaves(facade)
        check(bool(got) and len(got) == len(want)
              and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"deprecated {name} differs from its facade call")
    torch.cuda.synchronize()
    return path_launches(kernels, ("klms_bank_chunk", "klms_bank_step",
                                   "bank_predict", "krls_bank_chunk",
                                   "krls_bank_step"))


def phase_distribution(seed, device, kernels) -> dict:
    """Phase 20: (a)-(d) on DIST_WORLD gloo ranks spawned on the card,
    held here against dense and plain runs; (e) the deprecated serve
    names. Returns the path's launches (the ranks' summed)."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    inp = dist_inputs(seed)
    inp_path, out_path = DIST_DIR / "inputs.npz", DIST_DIR / "results.pt"
    init = DIST_DIR / f"init-{os.getpid()}"
    for stale in (out_path, init):
        stale.unlink(missing_ok=True)
    np.savez(inp_path, **inp)
    torch.cuda.empty_cache()
    t0, t_spawn = time.perf_counter(), time.time()
    mp.start_processes(dist_rank, args=(DIST_WORLD, f"file://{init}",
                                        "abcd", str(inp_path),
                                        str(out_path)),
                       nprocs=DIST_WORLD, join=True, start_method="spawn")
    ranks_s, t_joined = time.perf_counter() - t0, time.time()
    res = torch.load(out_path, weights_only=False)
    entered, left = res.pop("stamps")  # rank 0's
    rank_parts = {"start": entered - t_spawn, **res["seconds"],
                  "stop": t_joined - left}
    launches = {n: int(sum(res[f"launches_{n}"])) for n in DIST_KERNELS}
    for n, count in launches.items():
        check(count > 0, f"kernel {n} was not launched by the ranks")
    t0 = time.perf_counter()
    figures = dist_controls(inp, res, device, "abcd")
    controls_s = time.perf_counter() - t0
    control_parts = figures.pop("seconds")
    t0 = time.perf_counter()
    shims = phase_shims(seed, device, kernels)
    shims_s = time.perf_counter() - t0
    for path in (inp_path, out_path, init):
        path.unlink(missing_ok=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "distribution", "world": res["world"],
          "backend": res["backend"], "ranks_on_one_card": True,
          **figures, "launches": {"ranks": launches, "shims": shims},
          "seconds": {"ranks": ranks_s, "rank_parts": rank_parts,
                      "controls": controls_s, "control_parts": control_parts,
                      "shims": shims_s, "total": seconds},
          "card": SMI})
    return add_launches(launches, shims)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rff_klms_step import (
        rff_klms_bank_chunk_cuda,
        rff_klms_bank_step_cuda,
    )
    from repro_torch.kernels.rff_krls_step import (
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rff_attention import (
        rff_attention_cuda,
        rff_attention_decode_block_cuda,
    )
    from repro_torch.kernels.rff_features import rff_features_cuda
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda
    from repro_torch.kernels.rff_scan import (
        rff_klms_chunk_elements_cuda,
        rff_krls_chunk_elements_cuda,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    global SMI
    SMI = smi
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build_s = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": build_s, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {log.stem}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    kernels = dict(zip(REPLACES, (
        rff_klms_bank_chunk_cuda, rff_klms_bank_step_cuda,
        rff_bank_predict_cuda, rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda, rff_features_cuda,
        rff_klms_chunk_elements_cuda, rff_krls_chunk_elements_cuda)))
    kernels.update(rff_decode_block=rff_attention_decode_block_cuda,
                   rff_linear_attention=rff_attention_cuda,
                   flash_attention=flash_attention_cuda)
    errs = phase_kernels(rng, device)
    launches = phase_server(args.seed, device, kernels)
    krls_errs, p_rels, krls_routes = phase_krls_kernels(rng, device)
    errs.update(krls_errs)
    krls_launches = phase_krls_server(args.seed, device, kernels)
    launches["bank_predict"] += krls_launches.pop("bank_predict")
    launches.update(krls_launches)
    times = phase_times(rng, device)
    # The replay slice, after every earlier phase, on its own generator.
    rrng = np.random.default_rng(args.seed + 3)
    errs.update(phase_replay_kernels(rrng, device))
    for paths in (phase_replay_server(args.seed, device, kernels),
                  phase_krls_replay_server(args.seed, device, kernels)):
        for name, n in paths.items():
            launches[name] = launches.get(name, 0) + n
    times.update(phase_replay_times(rrng, device))
    # The LM slice, after every earlier phase, on its own generator.
    lrng = np.random.default_rng(args.seed + 4)
    lm_errs, lm_tols, lm_rels, flash_routes = phase_lm_kernels(lrng, device)
    errs.update(lm_errs)
    launches.update(phase_lm_server(args.seed, device, kernels))
    launches.update(phase_lm_gqa_server(args.seed, device, kernels))
    times.update(phase_lm_times(lrng, device))
    # The remaining learners and the paper's experiments, after the LM
    # slice.
    nklms_launches, flush_ms = phase_nklms_server(args.seed, device, kernels)
    for learner in DICT_HP:
        flush_ms.update(phase_dictionary_server(args.seed, device, learner))
    emit({"phase": "learner_flush_ms", "bank": BANK, "chunk": CHUNK,
          **flush_ms})
    for paths in (nklms_launches,
                  phase_replay_server(args.seed, device, kernels, "nklms"),
                  phase_paper(args.seed, device, kernels)):
        for name, n in paths.items():
            launches[name] = launches.get(name, 0) + n
    # The feature families and the policy tier, after the paper phase.
    torch.cuda.empty_cache()
    add_launches(launches, phase_feature_families(args.seed, device, kernels))
    torch.cuda.empty_cache()
    add_launches(launches, phase_policy(args.seed, device, kernels))
    # The observability and recovery tier, after the policy phase.
    torch.cuda.empty_cache()
    add_launches(launches, phase_obs_recovery(args.seed, device, kernels))
    # The distribution tier and the deprecated serve names, after phase 19.
    torch.cuda.empty_cache()
    add_launches(launches, phase_distribution(args.seed, device, kernels))
    torch.cuda.synchronize()
    replaces, sources = {**REPLACES, **LM_REPLACES}, {**SOURCES, **LM_SOURCES}
    tolerance = {**TOLERANCE, **lm_tols}
    # flash_attention's headline is its main-path route (bf16, tensor
    # cores); each kernel with two routes lists each one under "routes".
    fl = flash_routes["tensor_core"]
    errs["flash_attention"], lm_rels["flash_attention"] = (
        fl["max_abs_err"], fl["err_of_max_plain"])
    tolerance["flash_attention"] = None
    timed = {name: times[name]["routes"] for name in ROUTE_SOURCES}
    measured = {"flash_attention": flash_routes, **krls_routes}
    routes = {name: {route: {
        "source": src, "launches": ROUTE_LAUNCHES.get(name, {}).get(route, 0),
        **{k: v for k, v in measured[name][route].items() if k != "cases"},
        **timed[name][route]} for route, src in per.items()}
        for name, per in ROUTE_SOURCES.items()}
    emit({"phase": "total", "seconds": time.perf_counter() - t_run,
          "card": smi})
    print(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "tolerance": tolerance[name],
         **({"p_rel_err": p_rels[name], "p_tolerance": P_TOL}
            if name in p_rels else {}),
         **({"tolerance_of_max_plain": (ATTN_BF16_TOL
                                        if name == "flash_attention"
                                        else ATTN_TOL),
             "err_of_max_plain": lm_rels[name]}
            if name in lm_rels else {}),
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms"),
         **({"tolerance_of": "max|s|",
             "read_block": {k: times["rff_features_read_block"][k]
                            for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "shape")}}
            if name == "rff_features" else {}),
         **({"d2048": {k: times["krls_chunk_elements_d2048"][k]
                       for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "shape")}}
            if name == "krls_chunk_elements" else {}),
         **({k: times[name][k] for k in ("bf16", "krls_read", "one_tenant")}
            if name == "bank_predict" else {}),
         **({"routes": routes[name]} if name in routes else {})}
        for name in replaces
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
