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
   launch); the read kernel's few-row route (z by (row tile, column
   tile) blocks, then a reduce launch in the bank route's order) against
   its plain version at FEW_SHAPES, both precisions, and bit for bit: each
   of the serving bank's 1024 tenants read alone (the few-row route)
   against its row of the bank's read, and both routes forced on the same
   inputs;
3. drives the KLMS main path: a ``make_server("klms")`` bank of 1024
   tenants with a d=128, D=2048 random-feature map and chunk=16 takes a
   ragged stream, flushes, drains and serves single-tenant and (1024, 64)
   block reads at f32 and bf16, and a ``make_tick`` lockstep tier ticks the
   bank; the kernel server is compared with the same server run with
   ``mode="ref"`` on the card, and each kernel's launch count must rise;
4. holds both KRLS kernels (chunk, step) against their plain versions at
   the serving shape (B=1024, d=5, D=300, T=16) and at ragged ones (D up
   to 1031, and a P that is not symmetric), each on the route
   ``krls_chunk_route`` picks (P's triangle resident in shared memory up
   to D = 335 at d = 5 for the short calls, where a step is the resident
   chunk kernel at T = 1; the compact route for the serving flush and
   beyond, at D = 400, 1024 and 1031, also against its own plain version;
   P streamed each tick, forced at D = 400), with the contracts of each
   route (T = 1 a step, P' exactly symmetric, masked ticks a no-op, bit for
   bit; a chunk of T equals T steps bit for bit on the resident and
   streaming routes, where the streaming step equals the routed step, and
   within F32_TOL and P_TOL on the compact route, where two calls, a
   tenant alone and calls of Tc ticks in order agree bit for bit; the
   serving shape on the resident route forced and on the compact route
   picked);
5. drives the KRLS main path: ``make_server("krls")`` at the paper's §6
   settings (d=5, D=300, sigma=5, lam=1e-4, beta=0.9995) with B=1024 and
   chunk=16, its reads and a ``make_tick("krls")`` tier, against the same
   server with ``mode="ref"`` and within the f32 error budget that a
   float64 run of the same stream measures;
6. times each kernel, its plain version and its bound at the serving
   shapes, the KRLS kernels' compact routes where they are picked (the
   serving bank at D = 400) in turns with the streaming route forced on
   the same inputs, both routes forced at D = 300 in turns (the chunk
   picks the compact one there, the step the resident one), and the read
   kernel on its bf16 route, at
   the KRLS read shape (d = 5, D = 300) and at one tenant (B = 1, the
   policy tier's and the quarantine's reads: the few-row route through the
   op in turns with the bank route forced and the plain version, f32 and
   bf16, and at the sharded KRLS predict's partial, (1, 64, 5, 8192));
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
    at the edges of the f32 route's tiles (S = 127, 128, 129, 2049) and at
    the launcher's (32, 64, 16), each route's error reported; on the f32
    route, at every shape, bit for bit two calls, and a call on two of the
    heads against those heads of the full call;
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
    on both routes, SDPA's backend and kernels named; the f32 route also
    at deepseek's MLA head (64, 2048, 192 -> 128) and the launcher's (32,
    64, 16), the latter by call and device time beside SDPA's; kernel 9 and its plain version by
    torch.profiler device time, since a one-token call's event time is
    the host's), the
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
    dense and plain controls run after the ranks have exited;
21. serves every remaining arch of repro at published width in bf16
    (``lm_families``, run after step 14 with the rest of the LM slice),
    random weights from --seed: (a) deepseek-v2-lite-16b
    at all 27 layers (MLA + a 64-expert top-6 MoE with 2 shared experts,
    30.2 GiB): ``make_prefill_step`` at B = 4, S = 2048 (kernel 11 once a
    layer at BH = 64, q/k 192, v 128), every layer's attention held against
    ``kernel_mode="ref"`` on its own input at 2e-2 of max|plain|, the
    logits' distance and the share of (token, layer) expert choices that
    differ from a ``kernel_mode="ref"`` run, the PR 14 budget rule against
    an f32 copy of its first 8 layers, ``generate`` of 16 greedy tokens
    after a 16-token prompt (the MLA latent cache, no kernel), kernel 11
    at the MLA shape against its plain version, SDPA and its bound, the
    prefill's tokens per second and profile (kernel 11 once a layer, no
    plain op) and decode ms a step; then the same weights with RFF
    attention (kernel 10 once a layer in prefill, kernel 9 in decode); (b)
    minicpm3-4b, command-r-35b, arctic-480b (cut to 2 of 35 layers),
    mamba2-130m, recurrentgemma-2b, internvl2-2b and musicgen-large (the
    last two prefilled through stub embeddings), each prefilled at B = 2,
    S = 2048 and generating 8 tokens, held the same way, and for the
    non-MoE families an f32 copy's decode against its forward (command-r
    at 4 layers). The phase must end within 90 s;
22. trains (``lm_train``, after step 21), random weights from --seed,
    bf16 weights and f32 moments: (a) qwen2-0.5b as published through
    ``make_train_step`` (2 microbatches of a 8 x 2048 batch from
    ``data.lm_data``, warmup_cosine): kernel 11 once a layer a
    microbatch in the forward (48 launches a step, none in the backward,
    which differentiates the plain version), the loss within 1e-2 of
    ``kernel_mode="ref"``'s, each leaf's gradient on the first 4 layers
    (one microbatch) within the bf16 budget of the plain path's distance
    from an f32 run and, at f32 through the CUDA-core flash route, within
    1e-4 of each leaf's norm of the plain gradient; step ms, tokens per
    second, peak GiB, the device's busy share, kernel 11's share of it
    and the backward recompute's share; a ``Trainer`` run of 4 steps
    equal bit for bit to 2 steps, a new ``Trainer``, a resume from its
    checkpoint and 2 more (under ``torch.use_deterministic_algorithms``,
    with ``CUBLAS_WORKSPACE_CONFIG`` set before torch starts); (b) the
    same with RFF attention (kernel 10), whose feature buffers' omega
    decays by AdamW's lr * 0.1 exactly on both paths; (c)
    deepseek-v2-lite-16b cut to 2 of 27 layers: two steps (MLA through
    kernel 11, the MoE's backward), finite losses, the gradient holds
    with the kernel run's MoE routes replayed in the others (the flips
    counted and printed); (d) ``repro_torch.launch.train --arch
    qwen2-0.5b --steps 200 --batch 8 --seq 64`` (reduced; kernel 11 at S
    = 64 on the f32 route), the mean loss of the last 20 steps below the
    first 20's;
23. runs the launch layer (``launch``): (a) inside step 22, its
    qwen2-0.5b GQA step with the state as DTensors on a one-rank ("data",
    "model") = (1, 1) NCCL mesh (params and moments placed by
    ``param_specs``/``moment_specs`` of train_4k, ``batch_axes`` from
    ``train_batch_axes``, ``grad_specs`` the param placements), bit for bit
    the plain step under deterministic algorithms, kernel 11 launched on
    the local shards once a layer a microbatch; (b) inside step 21, the
    deepseek prefill at B = 4, S = 2048 on DTensor weights under
    prefill_32k's layout, bit for bit the plain prefill, kernel 11 once a
    layer; (c) ``python -m repro_torch.launch.dryrun`` for qwen2-0.5b and
    deepseek-v2-lite-16b (each of the four shapes, 16 x 16 fake ranks) on
    the host's CPU while step 22 runs, each cell's per-rank bytes against
    the card's memory and its dominant roofline term (``roofline.HW()``,
    the H100's rates). The phase's target is 30 s;
24. serves KRLS at D = 1024 on the compact route (``krls_wide_server``,
    last): ``make_server("krls", bank=1024, chunk=16)`` at the paper's
    section 6 settings (d = 5, sigma = 5, lam = 1e-4, beta = 0.9995) with a
    random-feature map of D = 1024, the width repro's TPU kernel budgets a
    tenant's P for (4 GiB the bank), takes step 5's kind of ragged stream
    over six rounds, flushes and drains, serves (1024, 64) block reads and
    single-tenant reads through kernel 3 and ticks a ``make_tick("krls")``
    tier; every flush and tick must take the compact route. It is held
    against the same server with ``mode="ref"`` and within the float64
    budget of a float64 run of the first 64 tenants (rows are
    independent); then the flush's shape is timed on the compact route in
    turns with the streaming route forced, and its plain version. The
    phase's target is 60 s. The last phase line gives the whole run's
    seconds.

The line before the last is ``{"kernels": [...]}`` (flash_attention,
krls_bank_chunk and krls_bank_step with a record per route under
"routes", the KRLS chunk's compact record with the forced D = 300 and
the D = 1024 flush's times, flash_attention with an "mla" record of
phase 21's MLA shape
and its f32 route with "mla" and "launcher" records of step 14's,
bank_predict with "bf16", "krls_read" and "one_tenant" records beside
its f32 serving one and a record per route ("bank", "few") under
"routes", rff_features with a "read_block" record,
krls_chunk_elements with a "d2048" one); the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic under torch.use_deterministic_algorithms only
# with a fixed workspace, read when torch starts (phase 22's resume).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BANK, D_IN, D_FEAT, CHUNK, Q = 1024, 128, 2048, 16, 64
SIGMA = float(np.sqrt(D_IN))  # kernel bandwidth matched to |x| ~ sqrt(d)
MU = 0.5
F32_TOL = 1e-4  # FMA contraction, summation order and cosf vs torch.cos
BF16_TOL = 1e-3  # plus one-ulp bf16 flips of z at rounding boundaries
SERVER_TOL = 1e-4  # the recursion carries per-tick f32 differences
RAGGED = [(7, 5, 300), (1, 1, 17), (33, 128, 129)]  # (B, d, D)
# The read kernel's few-row route (csrc/bank_predict.cu bank_predict_few),
# held at (B, Q, d, D): one tenant at the KLMS serving widths, the KRLS
# read's and a compact width's, the sharded KRLS predict's partial (B = 1,
# D / n = 8192 at D = 32768 on four ranks) and ragged rows.
FEW_SHAPES = [(1, Q, D_IN, D_FEAT), (1, 1, D_IN, D_FEAT), (2, Q, D_IN, D_FEAT),
              (1, Q, 5, 300), (1, 13, 5, 400), (1, Q, 5, 8192),
              (7, 1, 5, 300), (129, 1, 7, 2049)]
SHARD_PARTIAL = (1, Q, 5, 8192)  # (B, Q, d, D)
PREDICT_ROUTE_SOURCES = {"bank": "src/repro_torch/csrc/bank_predict.cu",
                         "few": "src/repro_torch/csrc/bank_predict.cu"}
# KRLS serving: the paper's section 6 settings (src/repro/core/krls.py:122,
# benchmarks/paper.py:145) over the same bank, chunk and read block.
K_D_IN, K_D_FEAT, K_SIGMA, K_LAM, K_BETA = 5, 300, 5.0, 1e-4, 0.9995
K_RAGGED = [(3, 4, 17, 5), (5, 128, 129, 3), (2, 5, 1024, 4)]  # (B, d, D, T)
# The chunk kernel's routes: P resident in shared memory (D <= 335 at d =
# 5, for a step and the calls too short for the compact route to pay) or
# the compact route (blocks of Tc ticks, P moved once a block: the serving
# flush, and wider D, as at D = 400 here and D = 1024 above); P streamed
# each tick only where a call forces it (_route="streaming").
KRLS_ROUTES = ("resident", "compact", "streaming")
K_COMPACT = [(8, 5, 400, 6), (3, 5, 1031, 20)]  # (B, d, D, T)
K_FORCED_STREAMING = (8, 5, 400, 6)  # (B, d, D, T)
K_D_WIDE = 400  # the compact route's timing width (serving B, T and d)
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


def predict_contracts(rng, device, route_errs: dict) -> dict:
    """The read kernel's few-row route against its plain version at
    FEW_SHAPES, f32 and bf16, equal bit for bit to the bank route forced on
    the same inputs and to a second call; then each tenant of the serving
    bank read alone (the few-row route) against its row of the bank's read
    (the bank route), bit for bit. ``route_errs`` takes each route's
    largest error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import predict_route
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda as cuda

    for bank, qlen, d, dfeat in FEW_SHAPES:
        shape = (bank, qlen, d, dfeat)
        check(predict_route(bank * qlen, dfeat) == "few",
              f"read {shape} is not on the few-row route")
        a = inputs(rng, bank, qlen, d, dfeat, device)
        pargs = (a["theta"], a["xs"], a["w"], a["b"], a["s"])
        for precision, tol in ((None, F32_TOL), ("bf16", BF16_TOL)):
            few = cuda(*pargs, precision=precision, _route="few")
            e = hold(f"bank_predict few {precision} {shape}", [few],
                     [ops.rff_bank_predict(*pargs, mode="ref",
                                           precision=precision)], tol)
            route_errs["few"] = max(route_errs["few"], e)
            check(torch.equal(few, cuda(*pargs, precision=precision,
                                        _route="bank")),
                  f"read {precision} {shape}: the routes' bits differ")
            check(torch.equal(few, cuda(*pargs, precision=precision,
                                        _route="few")),
                  f"read {precision} {shape}: two calls differ")
    check(predict_route(BANK * Q, D_FEAT) == "bank",
          "the serving read is off the bank route")
    a = inputs(rng, BANK, Q, D_IN, D_FEAT, device)
    for precision in (None, "bf16"):
        full = cuda(a["theta"], a["xs"], a["w"], a["b"], a["s"],
                    precision=precision)
        for t in range(BANK):
            one = cuda(a["theta"][t:t + 1], a["xs"][t:t + 1], a["w"],
                       a["b"], a["s"], precision=precision)
            check(torch.equal(one[0], full[t]),
                  f"read {precision}: tenant {t} alone differs from its "
                  f"row of the B = {BANK} read")
    return {"few_shapes": FEW_SHAPES, "few_eq_bank_forced": True,
            "two_calls": True, f"b1_eq_row_of_b{BANK}_read": BANK}


def phase_kernels(rng, device) -> tuple[dict, dict]:
    """Every kernel against its plain version, and the bitwise contracts.
    Returns the errors and the read kernel's per-route errors."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import predict_route

    errs = {"klms_bank_chunk": 0.0, "klms_bank_step": 0.0, "bank_predict": 0.0}
    route_errs = {"bank": 0.0, "few": 0.0}
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
            route = predict_route(bank * qlen, dfeat)
            route_errs[route] = max(route_errs[route], e)

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
    reads = predict_contracts(rng, device, route_errs)
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "shapes": shapes, "max_abs_err": errs,
          "tolerance": {"f32": F32_TOL, "bf16_predict": BF16_TOL},
          "bitwise": {"chunk16_eq_16_steps": True, "chunk1_eq_step": True,
                      "masked_tick_noop": True,
                      f"b1_eq_row_of_b{BANK}": list(rows)},
          "predict_routes": {"max_abs_err": route_errs, **reads}})
    return errs, {r: {"max_abs_err": e} for r, e in route_errs.items()}


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


def krls_contracts(a, route, forced=False) -> None:
    """The bitwise contracts of the chunk route that a's shape picks
    (``route``, checked on every launch) or that ``forced`` forces: T = 1
    equals one step on the step's route (the chunk's at T = 1), P' of a symmetric P is exactly
    symmetric, masked ticks leave theta and P bit for bit in fresh tensors
    and emit the prior prediction. A chunk of T equals T step launches bit
    for bit on the resident and streaming routes, where a chain of
    streaming step launches also equals the routed steps at every tick; on
    the compact route within F32_TOL and P_TOL (hold_krls: its blocks
    reassociate the recursion), and there two calls agree, a tenant alone
    equals its row of the bank and calls of Tc ticks in order equal one
    call, bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import KRLS_COMPACT_TC
    from repro_torch.kernels.rff_krls_step import (
        krls_step_route,
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    kw = {"_route": route} if forced else {}
    common = (a["w"], a["b"], a["beta"])
    bank, tlen, d = a["xs"].shape
    step_route = route if forced else krls_step_route(
        bank, a["theta"].shape[1], d)
    tag = f"krls {route} {tuple(a['pmat'].shape)}"
    counts = rff_krls_bank_chunk_cuda.route_launches

    def chunk_of(*args, expect=route):
        before = counts[expect]
        out = rff_krls_bank_chunk_cuda(*args, **kw)
        check(counts[expect] == before + 1, f"{tag}: launched another route")
        return out

    def step_of(*args):
        if forced:
            return rff_krls_bank_step_cuda(*args, **kw)
        return ops.rff_krls_bank_step(*args, mode="cuda")

    args = (a["theta"], a["pmat"], a["xs"], a["ys"], *common, None, a["s"])
    chunk = chunk_of(*args)
    check(torch.equal(chunk[1], chunk[1].transpose(1, 2)),
          f"{tag}: P' of a symmetric P is not exactly symmetric")
    bitwise = route != "compact"
    theta, pmat = a["theta"], a["pmat"]
    stheta, spmat = theta, pmat
    preds, errs = [], []
    for t in range(tlen):
        x_t, y_t = a["xs"][:, t].contiguous(), a["ys"][:, t].contiguous()
        theta, pmat, pred, err = step_of(theta, pmat, x_t, y_t, *common,
                                         a["s"])
        preds.append(pred)
        errs.append(err)
        if bitwise:
            check(torch.equal(pred, chunk[2][:, t])
                  and torch.equal(err, chunk[3][:, t]),
                  f"{tag}: chunk of {tlen} vs steps: tick {t} outputs differ")
            # A chain of the streaming step kernel equals the routed steps.
            streamed = rff_krls_bank_step_cuda(stheta, spmat, x_t, y_t,
                                               *common, a["s"],
                                               _route="streaming")
            check(all(torch.equal(u, v) for u, v in
                      zip(streamed, (theta, pmat, pred, err))),
                  f"{tag}: the streaming step vs the routed step: tick {t} "
                  "differs")
            stheta, spmat = streamed[0], streamed[1]
            del streamed
        if t == 0:
            one = chunk_of(a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
                           a["ys"][:, :1].contiguous(), *common, None, a["s"],
                           expect=step_route)
            check(all(torch.equal(u, v) for u, v in
                      zip(one, (theta, pmat, pred[:, None], err[:, None]))),
                  f"{tag}: chunk at T=1 vs step differ")
    if bitwise:
        check(torch.equal(theta, chunk[0]) and torch.equal(pmat, chunk[1]),
              f"{tag}: chunk of {tlen} vs steps: theta or P differs")
    else:
        hold_krls(f"{tag}: chunk of {tlen} vs steps", chunk,
                  (theta, pmat, torch.stack(preds, 1), torch.stack(errs, 1)))
        again = chunk_of(*args)
        check(all(torch.equal(u, v) for u, v in zip(again, chunk)),
              f"{tag}: two calls differ")
        row = a["theta"].shape[0] - 1
        alone = chunk_of(*(t[row:row + 1].contiguous() for t in args[:4]),
                         a["w"], a["b"], a["beta"][row:row + 1].contiguous(),
                         None, a["s"])
        check(all(torch.equal(u[0], v[row]) for u, v in zip(alone, chunk)),
              f"{tag}: a tenant alone differs from its row of the bank")
        stheta, spmat, parts = a["theta"], a["pmat"], []
        for t0 in range(0, tlen, KRLS_COMPACT_TC):
            t1 = min(tlen, t0 + KRLS_COMPACT_TC)
            stheta, spmat, p, e = chunk_of(
                stheta, spmat, a["xs"][:, t0:t1].contiguous(),
                a["ys"][:, t0:t1].contiguous(), *common, None, a["s"])
            parts.append((p, e))
        check(torch.equal(stheta, chunk[0]) and torch.equal(spmat, chunk[1])
              and torch.equal(torch.cat([p for p, _ in parts], 1), chunk[2]),
              f"{tag}: calls of Tc ticks in order differ from one call")
        del again, alone, parts
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
    """Both KRLS kernels against their plain versions, each on the route
    krls_chunk_route picks: P resident in shared memory up to D = 335 at d
    = 5 for a step and the short calls (the chunk kernel, at T = 1 for a
    step); the compact route for the serving flush and beyond (blocks of Tc
    ticks, at T = 1 for a step past D = 335), held also against its own
    plain version (krls_chunk_compact_ref); the streaming design forced at
    D = 400. Then the contracts of each route, the serving shape's on the
    resident route forced and on the compact route picked."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import krls_chunk_compact_ref
    from repro_torch.kernels.rff_krls_step import (
        krls_chunk_route,
        krls_step_route,
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    names = ("krls_bank_chunk", "krls_bank_step")
    errs, shares, rels = (dict.fromkeys(names, 0.0) for _ in range(3))
    by_route = {name: {r: {"max_abs_err": 0.0, "p_rel_err": 0.0, "cases": []}
                       for r in KRLS_ROUTES} for name in names}
    cases = [(BANK, K_D_IN, K_D_FEAT, CHUNK, "eye"),
             (BANK, K_D_IN, K_D_FEAT, CHUNK, "spd")]
    cases += [(*shape, "spd") for shape in K_RAGGED] + [(4, 5, 70, 6, "asym")]
    cases += [(*shape, kind) for shape in K_COMPACT for kind in ("spd", "asym")]
    cases += [(*K_FORCED_STREAMING, kind, "streaming") for kind in ("spd", "asym")]
    vs_compact_ref = {"max_abs_err": 0.0, "p_rel_err": 0.0}
    for bank, d, dfeat, tlen, kind, *forced in cases:
        a = krls_inputs(rng, bank, tlen, d, dfeat, device, kind)
        args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
                a["beta"], a["mask"], a["s"])
        sargs = (a["theta"], a["pmat"], a["xs"][:, 0].contiguous(),
                 a["ys"][:, 0].contiguous(), a["w"], a["b"], a["beta"], a["s"])
        route = forced[0] if forced else krls_chunk_route(bank, tlen, dfeat, d)
        step_route = forced[0] if forced else krls_step_route(bank, dfeat, d)
        if forced:
            kern = (rff_krls_bank_chunk_cuda(*args, _route=route),
                    rff_krls_bank_step_cuda(*sargs, _route=route))
        else:
            kern = (ops.rff_krls_bank_chunk(*args, mode="cuda"),
                    ops.rff_krls_bank_step(*sargs, mode="cuda"))
        plain = (ops.rff_krls_bank_chunk(*args, mode="ref"),
                 ops.rff_krls_bank_step(*sargs, mode="ref"))
        for name, got, want in zip(names, kern, plain):
            e, f, r = hold_krls(f"{name} {bank, d, dfeat, tlen} P={kind} "
                                f"{route}", got, want)
            errs[name] = max(errs[name], e)
            shares[name] = max(shares[name], f)
            rels[name] = max(rels[name], r)
            rec = by_route[name][route if name == names[0] else step_route]
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["p_rel_err"] = max(rec["p_rel_err"], r)
            rec["cases"].append([bank, d, dfeat, tlen, kind])
        if route == "compact":
            e, _, r = hold_krls(f"krls_bank_chunk {bank, d, dfeat, tlen} "
                                f"P={kind} vs its compact plain version",
                                kern[0], krls_chunk_compact_ref(*args))
            vs_compact_ref["max_abs_err"] = max(vs_compact_ref["max_abs_err"], e)
            vs_compact_ref["p_rel_err"] = max(vs_compact_ref["p_rel_err"], r)
        del a, args, sargs, kern, plain

    serving = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_FEAT, device, "spd")
    krls_contracts(serving, "resident", forced=True)
    krls_contracts(serving, krls_chunk_route(BANK, CHUNK, K_D_FEAT, K_D_IN))
    del serving
    for bank, d, dfeat, tlen in K_COMPACT:
        krls_contracts(krls_inputs(rng, bank, tlen, d, dfeat, device, "spd"),
                       "compact")
    bank, d, dfeat, tlen = K_FORCED_STREAMING
    krls_contracts(krls_inputs(rng, bank, tlen, d, dfeat, device, "spd"),
                   "streaming", forced=True)
    torch.cuda.synchronize()
    emit({"phase": "krls_kernels_vs_plain",
          "cases": [list(c) for c in cases], "max_abs_err": errs,
          "max_share_of_tolerance": shares, "p_rel_err": rels,
          "routes": by_route, "compact_vs_its_plain_version": vs_compact_ref,
          "tolerance": {"theta_pred_err": F32_TOL, "p_of_max_abs_p": P_TOL},
          "bitwise_on_each_route": {"chunk1_eq_step": True,
                                    "masked_tick_noop_fresh_outputs": True,
                                    "p_out_exactly_symmetric": True},
          "bitwise_resident_and_streaming": {
              "chunk_eq_steps": True, "streaming_step_eq_routed_step": True},
          "compact": {"chunk_vs_steps": "F32_TOL, P_TOL",
                      "bitwise": ["two_calls", "tenant_alone_eq_its_row",
                                  "calls_of_tc_eq_one_call"]}})
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
    check(routes["compact"] > 0 and routes["streaming"] == 0
          and routes["resident"] + routes["compact"]
          == launches["krls_bank_chunk"],
          f"krls flushes at D = {K_D_FEAT} did not take the compact route: "
          f"{routes}")
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


def turns(run, routes, reps: int = 20) -> dict:
    """``run(route)`` timed for each of two routes in turns within one call
    (r0, r1, r1, r0): each route's better median and both readings."""
    runs = {r: [] for r in routes}
    for r in (*routes, *routes[::-1]):
        runs[r].append(time_ms(lambda: run(r), reps))
    return {r: {"ms": min(v), "ms_runs": v} for r, v in runs.items()}


def read_bound(bank: int, qlen: int, d: int, dfeat: int,
               bf16: bool) -> tuple[float, str]:
    """The read's bound at (B, Q, d, D): bytes W, b, s, theta, the queries
    and the output; operations 2 d D a row for the products (on the bf16
    route at the tensor cores' rate) and 5 D (bias, cos, scale, the theta
    . z multiply-add) at the f32 rate."""
    rows = bank * qlen
    nbytes = 4 * (d * dfeat + 2 * dfeat + bank * dfeat + rows * (d + 1))
    if not bf16:
        return bound_ms(nbytes, rows * (2 * d * dfeat + 5 * dfeat))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (rows * 2 * d * dfeat / BF16_OPS_PER_S
             + rows * 5 * dfeat / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def read_routes(theta, xq, w, b, s, precision=None) -> dict:
    """A read timed on both routes and its plain version in turns within
    one call (the bank route forced, the op on its own route, the plain
    version, then back), with its bound; the op's route must be "few"."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda as cuda

    runs = {
        "bank": lambda: cuda(theta, xq, w, b, s, precision=precision,
                             _route="bank"),
        "few": lambda: ops.rff_bank_predict(theta, xq, w, b, s, mode="cuda",
                                            precision=precision),
        "plain": lambda: ops.rff_bank_predict(theta, xq, w, b, s, mode="ref",
                                              precision=precision),
    }
    before = cuda.route_launches["few"]
    t = turns(lambda r: runs[r](), tuple(runs))
    check(cuda.route_launches["few"] > before,
          f"read {tuple(xq.shape)} {precision} was timed off the few-row route")
    bank, qlen, d = xq.shape
    bound, bound_by = read_bound(bank, qlen, d, theta.shape[-1],
                                 precision == "bf16")
    return {"ms": t["few"]["ms"], "ms_runs": t["few"]["ms_runs"],
            "plain_ms": t["plain"]["ms"], "plain_ms_runs": t["plain"]["ms_runs"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "bank_ms": t["bank"]["ms"], "bank_ms_runs": t["bank"]["ms_runs"],
            "shape": [bank, qlen, d, theta.shape[-1]]}


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
    are timed at D = 300 on the route each picks there (the chunk's compact
    route, the step's resident one) and on their compact route at D =
    K_D_WIDE; the streaming route forced at D = K_D_WIDE in turns with the
    compact one, and both routes forced at D = 300 in turns, are recorded
    beside them.
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
        krls_chunk_route,
        krls_step_route,
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    counts = {name: k_.route_launches for name, k_ in (
        ("krls_bank_chunk", rff_krls_bank_chunk_cuda),
        ("krls_bank_step", rff_krls_bank_step_cuda))}
    picked = {"krls_bank_chunk": krls_chunk_route(BANK, CHUNK, K_D_FEAT,
                                                  K_D_IN),
              "krls_bank_step": krls_step_route(BANK, K_D_FEAT, K_D_IN)}
    before = {name: dict(c) for name, c in counts.items()}
    out = {name: timed_case(*case) for name, case in cases.items()}
    for name, c in counts.items():
        check(all((c[r] > before[name][r]) is (r == picked[name])
                  for r in KRLS_ROUTES),
              f"{name} at D = {K_D_FEAT} was timed off its {picked[name]} "
              "route")
    # Both routes forced at D = 300, in turns within this call: the table
    # behind the pick there (chunking.krls_compact_pays).
    runs = {"krls_bank_chunk": lambda r: rff_krls_bank_chunk_cuda(
                k["theta"], k["pmat"], k["xs"], k["ys"], k["w"], k["b"],
                k["beta"], None, k["s"], _route=r),
            "krls_bank_step": lambda r: rff_krls_bank_step_cuda(
                k["theta"], k["pmat"], kx0, ky0, k["w"], k["b"], k["beta"],
                k["s"], _route=r)}
    at300 = {name: turns(run, ("resident", "compact"))
             for name, run in runs.items()}
    del runs
    # Both KRLS kernels' compact routes where they are picked: the serving
    # bank at D = K_D_WIDE, past the resident triangle's shared memory;
    # then the streaming design forced on the same inputs, in turns with
    # the compact route.
    kw = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_WIDE, device, "eye")
    kw0, kwy0 = kw["xs"][:, 0].contiguous(), kw["ys"][:, 0].contiguous()
    before = {name: dict(c) for name, c in counts.items()}
    wide = {"krls_bank_chunk": timed_case(*krls_chunk_case(kw), plain_reps=5),
            "krls_bank_step": timed_case(
                lambda m: ops.rff_krls_bank_step(
                    kw["theta"], kw["pmat"], kw0, kwy0, kw["w"], kw["b"],
                    kw["beta"], kw["s"], mode=m),
                *krls_cost(K_D_WIDE, 1), plain_reps=5)}
    for name, c in counts.items():
        check(c["compact"] > before[name]["compact"]
              and c["streaming"] == before[name]["streaming"],
              f"{name} at D = {K_D_WIDE} was timed off its compact route")
    runs = {"krls_bank_chunk": lambda r: rff_krls_bank_chunk_cuda(
                kw["theta"], kw["pmat"], kw["xs"], kw["ys"], kw["w"],
                kw["b"], kw["beta"], None, kw["s"], _route=r),
            "krls_bank_step": lambda r: rff_krls_bank_step_cuda(
                kw["theta"], kw["pmat"], kw0, kwy0, kw["w"], kw["b"],
                kw["beta"], kw["s"], _route=r)}
    forced = {name: turns(run, ("compact", "streaming"), reps=10)
              for name, run in runs.items()}
    del kw, kw0, kwy0, runs
    keys = ("ms", "ms_runs", "plain_ms", "bound_ms", "bound_by")
    for name in counts:
        row, tlen = out[name], CHUNK if name == "krls_bank_chunk" else 1
        streaming, res300 = forced[name]["streaming"], at300[name]["resident"]
        compact300 = at300[name]["compact"]
        row["routes"] = {
            "resident": {"ms": res300["ms"], "ms_runs": res300["ms_runs"],
                         **{k_: row[k_] for k_ in keys[2:]},
                         "library_ms": None,
                         "picked": picked[name] == "resident",
                         "shape": [BANK, tlen, K_D_IN, K_D_FEAT]},
            "compact": {**{k_: wide[name][k_] for k_ in keys},
                        "library_ms": None,
                        "shape": [BANK, tlen, K_D_IN, K_D_WIDE],
                        "turns_with_streaming_ms": forced[name]["compact"],
                        "at_d300": {
                            "ms": compact300["ms"],
                            "ms_runs": compact300["ms_runs"],
                            "picked": picked[name] == "compact",
                            "bound_ms": row["bound_ms"],
                            "shape": [BANK, tlen, K_D_IN, K_D_FEAT]}},
            "streaming": {"ms": streaming["ms"],
                          "ms_runs": streaming["ms_runs"],
                          "plain_ms": wide[name]["plain_ms"],
                          "bound_ms": wide[name]["bound_ms"],
                          "bound_by": wide[name]["bound_by"],
                          "library_ms": None, "forced": True,
                          "shape": [BANK, tlen, K_D_IN, K_D_WIDE]}}
    keys = ("ms", "ms_runs", "plain_ms", "plain_ms_runs", "bound_ms",
            "bound_by")
    pred = out["bank_predict"]
    bf16 = timed_case(lambda m: ops.rff_bank_predict(
        a["theta"], xq, a["w"], a["b"], a["s"], mode=m, precision="bf16"),
        shared + 4 * (BANK * D_FEAT + BANK * Q * (D_IN + 1)), 0.0)
    bf16["bound_ms"], bf16["bound_by"] = read_bound(BANK, Q, D_IN, D_FEAT,
                                                    True)
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
    # the quarantine's predict_row) at the KLMS serving widths, on the
    # few-row route through the op in turns with the bank route forced, f32
    # and bf16; and the sharded KRLS predict's partial.
    one = [a["theta"][:1], xq[:1], a["w"], a["b"], a["s"]]
    pred["one_tenant"] = read_routes(*one)
    pred["one_tenant"]["bf16"] = read_routes(*one, precision="bf16")
    bank, qlen, d, dfeat = SHARD_PARTIAL
    sp = inputs(rng, bank, qlen, d, dfeat, device)
    pred["one_tenant"]["shard_partial"] = read_routes(
        sp["theta"], sp["xs"], sp["w"], sp["b"], sp["s"])
    del one, sp
    pred["routes"] = {
        "bank": {**{k_: pred[k_] for k_ in keys}, "library_ms": None,
                 "shape": [BANK, Q, D_IN, D_FEAT],
                 "one_tenant_forced_ms": pred["one_tenant"]["bank_ms"]},
        "few": {k_: v for k_, v in pred["one_tenant"].items()
                if k_ not in ("bf16", "shard_partial")}}
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
# Each route of the kernels that have more than one, and its source (the
# KRLS step's resident and compact routes are those chunk kernels at T = 1;
# its streaming route, forced only, the streaming step kernel).
KRLS_ROUTE_SOURCES = {"resident": "src/repro_torch/csrc/krls_bank.cu",
                      "compact": "src/repro_torch/csrc/krls_compact.cu",
                      "streaming": "src/repro_torch/csrc/krls_bank.cu"}
ROUTE_SOURCES = {
    "bank_predict": PREDICT_ROUTE_SOURCES,
    "flash_attention": {
        "tensor_core": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "cuda_core": "src/repro_torch/csrc/flash_attention.cu"},
    "krls_bank_chunk": KRLS_ROUTE_SOURCES,
    "krls_bank_step": KRLS_ROUTE_SOURCES,
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
# 256 (two V passes on the bf16 route); then the edges of the f32 route's
# 128-row and 64-key tiles (S = 127, 128, 129, 2049) and the launcher's
# reduced qwen2 (batch 8, 4 heads of 16, S = 64: one 64-row tile).
FLASH_SHAPES = [(56, LM_S, 64, 64), (32, 1024, 128, 128), (3, 100, 24, 24),
                (8, 512, 192, 128), (8, 512, 96, 64), (4, 512, 256, 256),
                (2, 127, 64, 64), (2, 128, 64, 64), (2, 129, 64, 64),
                (1, 2049, 64, 64), (32, 64, 16, 16)]
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


def flash_f32_bitwise(q, k, v, got, causal) -> None:
    """Fail unless the f32 flash route's second call gives ``got``'s bits
    and a call on the last and the first head gives those heads' bits."""
    from repro_torch.kernels import ops

    shape = tuple(q.shape) + (v.shape[-1],)
    check(torch.equal(got, ops.flash_attention(q, k, v, mode="cuda",
                                               causal=causal)),
          f"flash f32 {shape} causal={causal}: two calls differ")
    heads = [q.shape[0] - 1, 0] if q.shape[0] > 1 else [0]
    sub = ops.flash_attention(*(t[heads].contiguous() for t in (q, k, v)),
                              mode="cuda", causal=causal)
    check(torch.equal(sub, got[heads]), f"flash f32 {shape} causal={causal}: "
          "a head's bits depend on the call's other heads")


def phase_lm_kernels(rng, device) -> dict:
    """Kernels 9-11 against their plain versions at qwen2-0.5b's shapes,
    llama3-8b's head width and padded shapes; at every decode head a block
    of T equals T one-token launches bit for bit; the first dv tile of
    both RFF kernels equals a call on its columns alone, and two
    linear-attention launches give the same bits. The f32 flash route's
    bits: at every FLASH_SHAPES entry two calls agree, and a call on a
    subset of heads (the last and the first) equals those heads of the
    full call."""
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
    bitwise, tiles, flash_bits = {}, {}, {}

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
                    flash_f32_bitwise(q, k, v, got, causal)
                    flash_bits[f"{bh}_{slen}_{dh}_{dv}_{causal}"] = True
                del got
            del q, k, v
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels_vs_plain", "decode_shapes": DECODE_SHAPES,
          "linear_shapes": LINEAR_SHAPES, "flash_shapes": FLASH_SHAPES,
          "max_abs_err_f32": errs, "abs_tolerance_at_max_err_f32": tols,
          "max_err_of_max_plain_f32": rels,
          "tolerance_of_max_plain": {"f32": ATTN_TOL, "bf16": ATTN_BF16_TOL},
          "flash_routes": flash_routes,
          "bitwise_block_eq_one_token_launches": bitwise,
          "bitwise_flash_f32_reruns_and_head_subsets": flash_bits,
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
    last one (``profiles`` says how many were taken); so is a profile with
    no CUDA kernel record at all, and the run fails if the last has none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # The program's spans are profiler ranges too: their device-side
        # copies (user annotations) are no kernels.
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        names = {e.key: e.count for e in kern}
        if kern and (expect is None or expect(names)):
            break
    check(bool(kern), f"torch.profiler recorded no CUDA kernel in {tries} "
          "profiles")
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


# The f32 flash route beside qwen2-0.5b's prefill: deepseek-v2-lite's MLA
# head at B = 4 (16 heads of (192, 128)) and the launcher's reduced qwen2
# (launch.train's --batch 8 --seq 64: 4 heads of 16).
FLASH_F32_MLA = (LM_B * 16, LM_S, 192, 128)
FLASH_F32_LAUNCHER = (32, 64, 16, 16)
FLASH_F32_LAUNCHER_B = 8


def sdpa_yardstick(q4, k4, v4) -> dict:
    """SDPA (``is_causal=True``) on these (B, H, S, d) inputs: its time,
    the backend torch picks and the kernels it launched (torch.profiler),
    the yardstick's own record."""
    import torch.nn.functional as F

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    prof = device_busy(sdpa, top=3)
    return {"library_ms": time_ms(sdpa), "library_backend": sdpa_backend(
                q4, k4, v4),
            "library_kernels": [name for name, _, _ in prof["top"]]}


def flash_f32_shapes(rng, device) -> dict:
    """The f32 flash route at FLASH_F32_MLA against its plain version, its
    bound (2 (dh + dv) + 3 operations a kept pair at the f32 rate; q, k, v
    and the output once) and SDPA; at FLASH_F32_LAUNCHER against the same
    bound and SDPA, each by its call's time and its device time per call
    over DECODE_CALLS calls (torch.profiler: the calls are host-bound)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    bh, slen, dh, dv = FLASH_F32_MLA
    q, k = (f32_tensor(rng, bh, slen, dh, device=device) for _ in range(2))
    v = f32_tensor(rng, bh, slen, dv, device=device)
    pairs = bh * slen * (slen + 1) // 2
    mla = timed_case(lambda m: ops.flash_attention(q, k, v, mode=m),
                     4 * bh * slen * (2 * dh + 2 * dv),
                     pairs * (2 * dh + 2 * dv + 3), plain_reps=5)
    mla.update(sdpa_yardstick(*(x.view(LM_B, bh // LM_B, slen, x.shape[-1])
                                for x in (q, k, v))),
               shape=list(FLASH_F32_MLA))
    del q, k, v
    bh, slen, dh, dv = FLASH_F32_LAUNCHER
    q, k, v = (f32_tensor(rng, bh, slen, w, device=device)
               for w in (dh, dh, dv))
    q4, k4, v4 = (x.view(FLASH_F32_LAUNCHER_B, bh // FLASH_F32_LAUNCHER_B,
                         slen, x.shape[-1]) for x in (q, k, v))

    def call():
        return ops.flash_attention(q, k, v, mode="cuda")

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    kern = device_busy(lambda: [call() for _ in range(DECODE_CALLS)])
    lib = device_busy(lambda: [sdpa() for _ in range(DECODE_CALLS)])
    pairs = bh * slen * (slen + 1) // 2
    bound, bound_by = bound_ms(4 * bh * slen * (2 * dh + 2 * dv),
                               pairs * (2 * dh + 2 * dv + 3))
    return {"mla": mla, "launcher": {
        "ms": time_ms(call), "device_ms": kern["device_ms"] / DECODE_CALLS,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": time_ms(sdpa),
        "library_device_ms": lib["device_ms"] / DECODE_CALLS,
        "library_backend": sdpa_backend(q4, k4, v4),
        "shape": list(FLASH_F32_LAUNCHER)}}


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
    output. The f32 route also at deepseek's MLA head and the launcher's
    shape (:func:`flash_f32_shapes`), SDPA's backend and kernels named.
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
    # the f32 rate, and SDPA on f32 inputs (its backend and kernels named);
    # then deepseek's MLA head and the launcher's shape on this route.
    q, k, v = (x.float() for x in (q, k, v))
    f32 = timed_case(lambda m: ops.flash_attention(q, k, v, mode=m),
                     4 * 4 * bh * slen * dh, pairs * (4 * dh + 3), plain_reps=5)
    q4, k4, v4 = (x.view(LM_B, bh // LM_B, slen, dh) for x in (q, k, v))
    t_f32 = time.perf_counter()
    f32.update(sdpa_yardstick(q4, k4, v4))
    del q, k, v, q4, k4, v4
    f32.update(flash_f32_shapes(rng, device))
    # The f32 yardstick's profile and the MLA and launcher shapes, timed
    # apart (the phase's share of the run's time limit).
    f32_extra_s = time.perf_counter() - t_f32
    case["routes"] = {"tensor_core": {k_: case[k_] for k_ in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}, "cuda_core": {
        k_: f32[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "library_backend",
                               "library_kernels", "mla", "launcher")}}

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
                     "flash_bf16": FLASH_SHAPES[0],
                     "flash_f32": FLASH_SHAPES[0],
                     "flash_f32_mla": FLASH_F32_MLA,
                     "flash_f32_launcher": FLASH_F32_LAUNCHER},
          "library_ms": "flash: F.scaled_dot_product_attention(is_causal=True) "
                        "on (B, H, S, dh) bf16 and f32; none for kernels 9-10",
          "flash_f32_extra_seconds": f32_extra_s})
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


# ---------------------------------------------------------------------------
# Phase 21 (lm_families): every remaining arch of repro at published width
# ---------------------------------------------------------------------------

# (a) deepseek-v2-lite-16b (src/repro/configs/deepseek_v2_lite_16b.py) as
# published: 27 layers, d_model 2048, MLA with 16 heads (q/k 128 + 64, v
# 128, kv_lora_rank 512), a 64-expert top-6 MoE with 2 shared experts,
# vocab 102400; bf16 (30.2 GiB). make_prefill_step at B = 4, S = 2048 (kernel
# 11 once a layer at BH = 64, q/k 192, v 128), then generate after a
# 16-token prompt, then the same weights with RFF attention (kernels 10 and
# 9) beside the MoE FFN.
FAM_ARCH, FAM_B, FAM_S, FAM_PROMPT, FAM_NEW, FAM_RFF_NEW = (
    "deepseek-v2-lite-16b", 4, 2048, 16, 16, 8)
# The f32 copy of deepseek (60 GiB) does not fit beside the bf16 model: the
# PR 14 budget rule runs on its first FAM_F32_LAYERS layers (a cut).
FAM_F32_LAYERS = 8
# (b) the other seven archs at published width: a prefill at B = 2, S =
# 2048 and OTHER_NEW greedy tokens after an OTHER_PROMPT-token prompt.
# Depth is cut only where the weights and the plain run's peak pass 75 GiB
# (arctic: 25.4 GiB a layer).
OTHER_ARCHS = ("minicpm3-4b", "command-r-35b", "arctic-480b", "mamba2-130m",
               "recurrentgemma-2b", "internvl2-2b", "musicgen-large")
OTHER_B, OTHER_S, OTHER_PROMPT, OTHER_NEW = 2, 2048, 8, 8
OTHER_LAYERS = {"arctic-480b": 2}  # arch -> layers run (a cut)
# Decode against forward (tests/test_models.py's rule, atol = rtol = 2e-3)
# on an f32 copy of the weights over DVF_TOKENS tokens, for the non-MoE
# families; at DVF_LAYERS where the f32 copy does not fit at full depth.
DVF_TOKENS, DVF_TOL = 8, 2e-3
DVF_LAYERS = {"command-r-35b": 4}
FAM_SECONDS = 90.0
# Kernel 11 at deepseek's MLA prefill: (BH, S, q/k head, v head).
MLA_FLASH = (FAM_B * 16, FAM_S, 192, 128)


@contextlib.contextmanager
def attention_holds(records: list):
    """While active, every full-sequence attention call of the model (MLA,
    GQA, RFF) also runs with kernel_mode="ref" on the same input and is
    held at ATTN_BF16_TOL; ``records`` gets (max abs err, its tolerance,
    share of max|plain|) per call. The model goes on with the call's own
    output."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import rff_attention as rff_mod

    saved = [(attn_mod, "mla_apply"), (attn_mod, "gqa_apply"),
             (rff_mod, "rff_attn_apply")]
    originals = [getattr(mod, name) for mod, name in saved]

    def wrap(fn, name):
        def call(p, cfg, x, *args, kernel_mode="auto", **kw):
            out = fn(p, cfg, x, *args, kernel_mode=kernel_mode, **kw)
            plain = fn(p, cfg, x, *args, kernel_mode="ref", **kw)
            records.append(hold_rel(f"{cfg.name} {name} layer {len(records)}",
                                    [out], [plain], ATTN_BF16_TOL))
            return out
        return call

    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, wrap(fn, name))
    try:
        yield records
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


@contextlib.contextmanager
def route_log(experts: list):
    """While active, each MoE layer's chosen experts (B, S, k) are
    appended to ``experts``."""
    from repro_torch.models import moe as moe_mod

    original = moe_mod.route

    def route(*args, **kw):
        out = original(*args, **kw)
        experts.append(out[0])
        return out

    moe_mod.route = route
    try:
        yield experts
    finally:
        moe_mod.route = original


def route_flips(a: list, b: list) -> float:
    """The share of (token, layer) pairs whose set of chosen experts
    differs between two runs."""
    check(len(a) == len(b) > 0, f"routes logged {len(a)} vs {len(b)}")
    differ = total = 0
    for x, y in zip(a, b):
        x, y = x.sort(dim=-1).values, y.sort(dim=-1).values
        differ += int((x != y).any(dim=-1).sum())
        total += x.shape[0] * x.shape[1]
    return differ / total


def family_kernels(cfg) -> tuple:
    """The kernels a prefill of ``cfg`` launches (once a layer)."""
    if cfg.mixer != "attention":
        return ()
    if cfg.attention == "rff":
        return ("rff_linear_attention",)
    return ("flash_attention",)


def mla_prefill_profile(layers: int, names: dict) -> bool:
    """Whether an MLA + MoE prefill's profile shows the tensor-core flash
    kernel once a layer and no op of its plain version: the only softmax
    kernels are the router's, one a layer (the plain attention would add
    one a layer)."""
    softmax = sum(n for key, n in names.items() if "softmax" in key.lower())
    return gqa_prefill_profile(layers, names) and softmax == layers


def prefill_inputs(cfg, gen, batch, slen, device) -> dict:
    """A prefill batch: token ids, or stub embeddings for the frontend
    archs."""
    from repro_torch.models.frontend import stub_embeddings

    if cfg.frontend is not None:
        return {"embeds": stub_embeddings(gen, cfg, batch, slen,
                                          device=device)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, slen),
                                    generator=gen, device=device)}


def serve_family(cfg, params, gen, device, kernels, batch, slen, prompt_len,
                 new) -> tuple[dict, dict]:
    """One arch's serving path on the card: make_prefill_step (launches
    counted over this call alone), the same prefill with every attention
    call held against kernel_mode="ref" on its input, a kernel_mode="ref"
    prefill (logits distance; MoE: the share of expert choices that differ),
    then ``generate`` of ``new`` greedy tokens. Returns (report, the
    prefill's and decode's launches)."""
    from repro_torch.serve.serve_loop import generate, path_logits
    from repro_torch.train.steps import make_prefill_step

    layers = cfg.num_layers
    names = family_kernels(cfg)
    batch_in = prefill_inputs(cfg, gen, batch, slen, device)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    v = cfg.vocab_size
    with torch.inference_mode():
        reset_launches(kernels)
        t0 = time.perf_counter()
        logits = make_prefill_step(cfg)(params, batch_in)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = path_launches(kernels, names)
        for name in names:
            check(launches[name] == layers,
                  f"{cfg.name} prefill launches {launches}: {layers} expected")
        quiet = [n for n in kernels if n not in names and kernels[n].launches]
        check(not quiet, f"{cfg.name} prefill launched {quiet}")
        t0 = time.perf_counter()
        holds, k_routes, p_routes = [], [], []
        with attention_holds(holds), route_log(k_routes):
            held = make_prefill_step(cfg)(params, batch_in)
        with route_log(p_routes):
            plain = make_prefill_step(cfg, kernel_mode="ref")(params, batch_in)
        check(bool(torch.isfinite(logits[:, :v]).all()),
              f"{cfg.name}: non-finite prefill logits")
        check(torch.equal(held, logits), f"{cfg.name}: two prefills differ")
        if not names:  # no kernel on the path: both modes are one program
            check(torch.equal(plain, logits),
                  f"{cfg.name}: kernel_mode changed a kernel-free prefill")
        held_s = time.perf_counter() - t0
        report = {
            "prefill_seconds": prefill_s,
            "held_and_plain_prefill_seconds": held_s,
            "attention_calls_held": len(holds),
            "attention_max_err_of_max_plain": max((h[2] for h in holds),
                                                  default=0.0),
            "logits_kernel_vs_plain": max_err(logits[:, :v], plain[:, :v]),
            "max_abs_logit": float(plain[:, :v].float().abs().max()),
        }
        if cfg.mixer == "attention":
            check(len(holds) == layers, f"{cfg.name}: {len(holds)} attention "
                  f"calls held, {layers} layers")
        if cfg.moe is not None:
            report["expert_choices_differ"] = route_flips(k_routes, p_routes)
        before = {n: k.launches for n, k in kernels.items()}
        t0 = time.perf_counter()
        toks = generate(params, cfg, prompt, steps=new,
                        max_len=prompt_len + new)
        torch.cuda.synchronize()
        report["generate_seconds"] = time.perf_counter() - t0
        steps = prompt_len + new - 1
        decode = {n: k.launches - before[n] for n, k in kernels.items()
                  if k.launches != before[n]}
        want = ({"rff_decode_block": steps * layers}
                if cfg.mixer == "attention" and cfg.attention == "rff" else {})
        check(decode == want, f"{cfg.name} decode launches {decode}, "
              f"expected {want}")
        for name, n in decode.items():
            launches[name] = launches.get(name, 0) + n
        t0 = time.perf_counter()
        seen = path_logits(params, cfg, prompt, toks,
                           max_len=prompt_len + new)
        check(tuple(toks.shape) == (batch, new)
              and bool(((toks >= 0) & (toks < v)).all()),
              f"{cfg.name}: generated tokens")
        check(torch.equal(toks.long(), seen.argmax(-1)),
              f"{cfg.name}: greedy tokens vs their logits")
        if names and "rff_decode_block" in want:
            plain_seen = path_logits(params, cfg, prompt, toks,
                                     max_len=prompt_len + new,
                                     kernel_mode="ref")
            report["decode_logits_kernel_vs_plain"] = max_err(
                seen[..., :v], plain_seen[..., :v])
        report["path_logits_seconds"] = time.perf_counter() - t0
        report["sample"] = toks[0].tolist()
    return report, launches


def decode_vs_forward(cfg, params, gen, device, layers=None) -> dict:
    """Token-by-token decode against the full-sequence forward on an f32
    copy of the weights (the first ``layers`` layers where given), the rule
    of tests/test_models.py (|dec - full| <= 2e-3 + 2e-3 |full|)."""
    from dataclasses import replace

    from repro_torch.models import decode_state_init, decode_step, forward

    if layers is not None:
        cfg = replace(cfg, num_layers=layers)
        params = dict(params, blocks=params["blocks"][:layers])
    cfg32 = replace(cfg, dtype="float32")
    p32 = as_f32(params)
    inputs = prefill_inputs(cfg, gen, OTHER_B, DVF_TOKENS, device)
    with torch.inference_mode():
        full = forward(p32, cfg32, inputs.get("tokens"), inputs.get("embeds"))
        state = decode_state_init(cfg32, OTHER_B, 2 * DVF_TOKENS,
                                  device=device)
        outs = []
        for i in range(DVF_TOKENS):
            if "tokens" in inputs:
                lg, state = decode_step(p32, cfg32, state,
                                        inputs["tokens"][:, i])
            else:
                lg, state = decode_step(p32, cfg32, state,
                                        embed_in=inputs["embeds"][:, i:i + 1])
            outs.append(lg)
        dec = torch.stack(outs, 1)[..., :cfg.vocab_size]
        full = full[..., :cfg.vocab_size]
        excess = float((dec - full).abs().sub(
            DVF_TOL + DVF_TOL * full.abs()).max())
    check(bool(torch.isfinite(dec).all()) and excess <= 0,
          f"{cfg.name}: f32 decode vs forward exceeds {DVF_TOL} (abs + rel) "
          f"by {excess:.3g}")
    del p32
    return {"layers": cfg.num_layers, "max_abs_err": max_err(dec, full),
            "max_abs_logit": float(full.abs().max()), "excess": excess}


def sdpa_backend(q, k, v) -> str:
    """The SDPA backend torch picks for a causal call on these inputs
    (``torch._fused_sdp_choice``, the dispatcher's own choice)."""
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, is_causal=True)
    return next(name for name, b in SDPBackend.__members__.items()
                if int(b.value) == choice)


def family_times(cfg, params, gen, device) -> dict:
    """deepseek's serving figures: kernel 11 at the MLA shape against its
    plain version, SDPA (the backend torch picks named) and the bound;
    prefill tokens per second with its device-busy profile (kernel 11 once
    a layer and no plain op); decode ms a step with its device-busy share.

    Flash's bound: 2 (dh + dv) operations per kept (query, key) pair (Q K^T
    and P V) and 3 more (subtract, exp, add), at the bf16 tensor-core
    rate; bytes: q, k, v and the output, once each."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models import decode_state_init, decode_step
    from repro_torch.serve.serve_loop import prefill_tokens
    from repro_torch.train.steps import make_prefill_step

    bh, slen, dh, dv = MLA_FLASH
    q, k = (torch.randn(bh, slen, dh, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn(bh, slen, dv, generator=gen, device=device).to(
        torch.bfloat16)
    pairs = bh * slen * (slen + 1) // 2
    nops = pairs * (2 * dh + 2 * dv + 3)
    nbytes = 2 * bh * slen * (2 * dh + 2 * dv)
    case = timed_case(lambda m: ops.flash_attention(q, k, v, mode=m),
                      nbytes, 0.0, plain_reps=5)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
    case.update(bound_ms=max(t_bytes, t_ops) * 1e3, ops=nops,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=list(MLA_FLASH))
    q4, k4, v4 = (x.view(FAM_B, bh // FAM_B, slen, x.shape[-1])
                  for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    case["library_ms"] = time_ms(sdpa)
    case["library_backend"] = sdpa_backend(q4, k4, v4)
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

    tokens = torch.randint(0, cfg.vocab_size, (FAM_B, FAM_S), generator=gen,
                           device=device)
    with torch.inference_mode():
        step = make_prefill_step(cfg)
        prefill = wall_ms(lambda: step(params, {"tokens": tokens}))
        expect = functools.partial(mla_prefill_profile, cfg.num_layers)
        busy = device_busy(lambda: step(params, {"tokens": tokens}),
                           expect=expect)
        names = busy.pop("names")
        shown = {key[:60]: n for key, n in names.items()
                 if any(w in key.lower() for w in ("flash", "softmax"))}
        check(expect(names), f"{cfg.name} prefill profile: kernels {shown}")
        busy["flash_and_softmax_launches"] = shown
        state = decode_state_init(cfg, FAM_B, FAM_NEW + 8, device=device)
        state, logits = prefill_tokens(params, cfg, state, tokens[:, :2])
        tok = logits.argmax(-1)
        for _ in range(2):  # warm-up
            logits, state = decode_step(params, cfg, state, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FAM_NEW):
            logits, state = decode_step(params, cfg, state, tok)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / FAM_NEW
        dbusy = device_busy(lambda: decode_step(params, cfg, state, tok))
        dbusy.pop("names")
    busy["busy_share"] = busy["device_ms"] / prefill
    dbusy["busy_share"] = dbusy["device_ms"] / decode_ms
    return {"flash_mla": case,
            "prefill_ms": prefill,
            "prefill_tokens_per_s": FAM_B * FAM_S / prefill * 1e3,
            "decode_ms_per_step": decode_ms,
            "decode_tokens_per_s": FAM_B / decode_ms * 1e3,
            "profile": {"prefill": busy, "decode_step": dbusy}}


def phase_lm_families(seed, device, kernels) -> tuple[dict, dict]:
    """Phase 21: (a) deepseek-v2-lite-16b at all 27 layers, MLA + MoE
    (kernel 11), its f32 budget at FAM_F32_LAYERS, its times, then with RFF
    attention (kernels 10 and 9); (b) the other seven archs. Each model is
    freed before the next. Returns (the path's launches, deepseek's
    times)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import rff_attention as rff_mod
    from repro_torch.models import with_rff_attention
    from repro_torch.train.steps import make_prefill_step

    t_phase = time.perf_counter()
    total = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(FAM_ARCH)
    t0 = time.perf_counter()
    params, gen = lm_model(cfg, seed + 21, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    report, launches = serve_family(cfg, params, gen, device, kernels, FAM_B,
                                    FAM_S, FAM_PROMPT, FAM_NEW)
    add_launches(total, launches)
    report.update(init_seconds=init_s, layers=cfg.num_layers,
                  params=cfg.param_count(),
                  weight_gib=sum(t.numel() * t.element_size()
                                 for t in _leaves(params)) / 2 ** 30)
    parts = {"init": init_s, "serve": time.perf_counter() - t_phase - init_s}
    t0 = time.perf_counter()
    # The PR 14 budget rule at the depth where the f32 copy fits.
    cut = replace(cfg, num_layers=FAM_F32_LAYERS)
    pcut = dict(params, blocks=params["blocks"][:FAM_F32_LAYERS])
    tokens = torch.randint(0, cfg.vocab_size, (FAM_B, FAM_S), generator=gen,
                           device=device)
    v = cfg.vocab_size
    with torch.inference_mode():
        kern = make_prefill_step(cut)(pcut, {"tokens": tokens})
        plain = make_prefill_step(cut, kernel_mode="ref")(pcut,
                                                         {"tokens": tokens})
        cut32, p32 = replace(cut, dtype="float32"), as_f32(pcut)
        exact = make_prefill_step(cut32, kernel_mode="ref")(p32,
                                                           {"tokens": tokens})
        report["f32_budget"] = {"layers": FAM_F32_LAYERS, **lm_budget(
            f"{FAM_ARCH} {FAM_F32_LAYERS}-layer prefill", kern[:, :v],
            plain[:, :v], exact[:, :v])}
    del pcut, p32, kern, plain, exact
    torch.cuda.empty_cache()
    parts["f32_budget"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    times = family_times(cfg, params, gen, device)
    parts["times"] = time.perf_counter() - t0
    # Phase 23 (b) on these weights.
    LAUNCH["prefill"] = launch_prefill_hold(cfg, params, seed + 23, kernels,
                                            device)
    t0 = time.perf_counter()
    # The same weights with RFF attention beside the MoE FFN.
    rcfg = with_rff_attention(cfg)
    rparams = dict(params, blocks=[
        dict(b, attn=rff_mod.rff_attn_init(gen, rcfg, rcfg.activation_dtype,
                                           device=device))
        for b in params["blocks"]])
    del params
    rreport, rlaunches = serve_family(rcfg, rparams, gen, device, kernels,
                                      FAM_B, FAM_S, FAM_PROMPT, FAM_RFF_NEW)
    add_launches(total, rlaunches)
    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab_size, (FAM_B, FAM_S),
                               generator=gen, device=device)
        busy = device_busy(
            lambda: make_prefill_step(rcfg)(rparams, {"tokens": tokens}),
            expect=functools.partial(rff_prefill_profile, cfg.num_layers))
    check(rff_prefill_profile(cfg.num_layers, busy["names"]),
          f"{FAM_ARCH} rff prefill profile")
    rreport["prefill_linear_attention_launches"] = {
        phase: sum(n for key, n in busy["names"].items() if phase in key)
        for phase in LINEAR_PHASE_KERNELS}
    del rparams
    torch.cuda.empty_cache()
    parts["rff"] = time.perf_counter() - t0
    emit({"phase": "lm_families", "arch": FAM_ARCH, "B": FAM_B,
          "prefill_S": FAM_S, "prompt": FAM_PROMPT, "new_tokens": FAM_NEW,
          "mla": report, "rff": rreport, "times": times,
          "seconds": parts,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "tolerance": {"attention_of_max_plain": ATTN_BF16_TOL,
                        "bf16_budget": {
                            "factor": LM_BUDGET,
                            "floor_of_max_logit": LM_BUDGET_FLOOR}},
          "card": SMI})
    # (b) the other archs.
    for i, arch in enumerate(OTHER_ARCHS):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        published = cfg.num_layers
        if arch in OTHER_LAYERS:
            cfg = replace(cfg, num_layers=OTHER_LAYERS[arch])
        torch.cuda.reset_peak_memory_stats()
        params, gen = lm_model(cfg, seed + 22 + i, device)
        report, launches = serve_family(cfg, params, gen, device, kernels,
                                        OTHER_B, OTHER_S, OTHER_PROMPT,
                                        OTHER_NEW)
        add_launches(total, launches)
        report.update(layers=cfg.num_layers, published_layers=published,
                      weight_gib=sum(t.numel() * t.element_size()
                                     for t in _leaves(params)) / 2 ** 30,
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if cfg.moe is None:
            layers = DVF_LAYERS.get(arch)
            if layers is not None:  # free the layers the f32 check skips
                params["blocks"] = params["blocks"][:layers]
                torch.cuda.empty_cache()
            report["f32_decode_vs_forward"] = decode_vs_forward(
                cfg, params, gen, device, layers)
        del params
        torch.cuda.empty_cache()
        report["seconds"] = time.perf_counter() - t0
        emit({"phase": "lm_families", "arch": arch, "mixer": cfg.mixer,
              "attention": cfg.attention, "frontend": cfg.frontend,
              "B": OTHER_B, "prefill_S": OTHER_S, "prompt": OTHER_PROMPT,
              "new_tokens": OTHER_NEW, **report, "card": SMI})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_families_total", "seconds": seconds,
          "limit_seconds": FAM_SECONDS, "launches": total, "card": SMI})
    check(seconds < FAM_SECONDS,
          f"phase lm_families took {seconds:.1f} s, over {FAM_SECONDS} s")
    return total, times


# ---------------------------------------------------------------------------
# Phase 22 (lm_train): the LM training half
# ---------------------------------------------------------------------------

# (a) qwen2-0.5b as published (src/repro/configs/qwen2_0_5b.py), bf16
# weights and f32 moments: make_train_step with TRAIN_MICRO microbatches
# of a TRAIN_B x TRAIN_S global batch under warmup_cosine; kernel 11 runs
# at (56, 2048, 64) once a layer a microbatch in the forward, none in the
# backward (the plain version's gradient). (b) the same with RFF attention
# (D = 256, kernel 10). (c) deepseek-v2-lite-16b cut to TRAIN_DS_LAYERS of
# its 27 layers (MLA through kernel 11, the MoE's backward). (d) the
# launcher, reduced (kernel 11 at S = 64 on the f32 route).
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_MICRO = "qwen2-0.5b", 8, 2048, 2
TRAIN_LR = dict(peak_lr=3e-4, warmup_steps=1, total_steps=100)
TRAIN_TIMED = 3  # timed steps after a warm-up one
# The gradient holds run on the first TRAIN_GRAD_LAYERS layers (a cut, as
# phase 21's f32 budget: the f32 copy and its gradients beside the bf16 model)
# on one microbatch: at f32 the kernel path within TRAIN_F32_TOL of each
# leaf's norm of the plain path; at bf16 each leaf no farther from the f32
# plain gradient than LM_BUDGET times the bf16 plain path's distance plus
# LM_BUDGET_FLOOR of its norm.
TRAIN_GRAD_LAYERS, TRAIN_F32_TOL = 4, 1e-4
TRAIN_LOSS_TOL = 1e-2  # kernel vs plain loss, absolute, near ln V ~ 11.9
TRAIN_RESUME = (4, 2)  # steps straight, and where the second run resumes
TRAIN_DS_LAYERS, TRAIN_DS_B = 2, 4
TRAIN_LAUNCH = ["--arch", "qwen2-0.5b", "--steps", "200", "--batch", "8",
                "--seq", "64"]
TRAIN_WINDOW = 20  # (d): mean loss over the first and the last 20 steps
TRAIN_DIR = ROOT / "build" / "train"


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms while active (CUBLAS_WORKSPACE_
    CONFIG is set before torch starts), without its NaN fill of fresh
    allocations (a cost, not a change of any result): the probes of
    ``nondeterministic_ops`` say which ops of the path need it."""
    from torch.utils import deterministic as det

    was, fill = (torch.are_deterministic_algorithms_enabled(),
                 det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        det.fill_uninitialized_memory = fill


def nondeterministic_ops(cfg, device) -> dict:
    """Each backward of the GQA training path that accumulates into shared
    rows, run twice on the same inputs at the path's shapes (one
    microbatch, bf16), outside deterministic mode: True where the two
    gradients differ in any bit. The KV heads' repeat_interleave (7 query
    heads a KV head), the embedding lookup (repeated token ids) and the
    loss's gather of the gold logit (one element a row)."""
    gen = torch.Generator(device=device).manual_seed(0)
    mb, dtype = TRAIN_B // TRAIN_MICRO, cfg.activation_dtype
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = torch.randn(mb, TRAIN_S, hkv, dh, generator=gen, device=device)
    table = torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen,
                        device=device)
    tokens = torch.randint(0, 64, (mb, TRAIN_S), generator=gen,
                           device=device)
    logits = torch.randn(mb, TRAIN_S, 4096, generator=gen, device=device)
    cases = {
        "repeat_interleave (GQA)": (kv.to(dtype), lambda x: torch.
                                    repeat_interleave(x, cfg.padded_heads
                                                      // hkv, dim=2)),
        "index (embedding)": (table.to(dtype), lambda x: x[tokens]),
        "gather (loss)": (logits, lambda x: torch.gather(
            x, -1, tokens[..., None].long())),
    }
    out = {}
    for name, (x, fn) in cases.items():
        x = x.requires_grad_()
        y = fn(x)
        g = torch.randn(y.shape, generator=gen, device=device).to(y.dtype)
        a, = torch.autograd.grad(fn(x), x, g)
        b, = torch.autograd.grad(fn(x), x, g)
        out[name] = not torch.equal(a, b)
    return out


def leaf_grads(cfg, params, tokens, mode):
    """(loss, each leaf's gradient) of lm_loss on ``tokens``."""
    from repro_torch.models import lm_loss
    from repro_torch.optim.tree import leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, tokens=tokens, kernel_mode=mode)
    flat = leaves(live)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.item(), [torch.zeros_like(p) if g is None else g
                         for p, g in zip(flat, got)]


@contextlib.contextmanager
def route_replay(log: dict):
    """The first run under it records each MoE layer's routing; later runs
    take those routes (their own gates gathered at the recorded experts and
    renormalized, so the router keeps its gradient) and count the (token,
    layer) pairs whose own choice differs in ``log["flips"]``."""
    from repro_torch.models import moe as moe_mod

    original = moe_mod.route
    log.setdefault("routes", [])
    log.setdefault("flips", 0)
    log.setdefault("pairs", 0)
    calls = iter(()) if not log["routes"] else iter(list(log["routes"]))

    def route(gates, top_k, capacity):
        own = original(gates, top_k, capacity)
        rec = next(calls, None)
        if rec is None:
            log["routes"].append(own[:3])
            return own
        expert, slot, keep = rec
        a, b = own[0].sort(dim=-1).values, expert.sort(dim=-1).values
        log["flips"] += int((a != b).any(dim=-1).sum())
        log["pairs"] += a.shape[0] * a.shape[1]
        topv = gates.gather(-1, expert)
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        return expert, slot, keep, topv

    moe_mod.route = route
    try:
        yield log
    finally:
        moe_mod.route = original


def grad_budget(name, cfg, params, tokens, replay=None) -> dict:
    """The gradient holds on ``params`` (already cut): f32 kernel vs f32
    plain within TRAIN_F32_TOL of each leaf's norm; bf16 kernel within the
    budget of the bf16 plain path's distance from the f32 plain path. With
    ``replay`` (a dict) the MoE routes of the bf16 kernel run are replayed
    in the others and their flips counted."""
    from dataclasses import replace

    ctx = (lambda: route_replay(replay)) if replay is not None else (
        contextlib.nullcontext)
    tokens = tokens.contiguous()
    with ctx():
        loss_k, kern = leaf_grads(cfg, params, tokens, "auto")
    with ctx():
        _, plain = leaf_grads(cfg, params, tokens, "ref")
    cfg32, p32 = replace(cfg, dtype="float32"), as_f32(params)
    with ctx():
        _, exact = leaf_grads(cfg32, p32, tokens, "ref")
    out = {"loss_kernel": loss_k, "leaves": len(kern)}
    worst_budget = worst_f32 = 0.0
    for i, (k, p, e) in enumerate(zip(kern, plain, exact)):
        check(bool(torch.isfinite(k).all()), f"{name}: leaf {i} non-finite")
        norm = float(e.norm())
        d_k, d_p = float((k.float() - e).norm()), float((p.float() - e).norm())
        allowed = LM_BUDGET * d_p + LM_BUDGET_FLOOR * norm
        check(d_k <= allowed, f"{name}: bf16 leaf {i} {tuple(k.shape)} "
              f"kernel {d_k:.3g} from f32, plain {d_p:.3g}")
        worst_budget = max(worst_budget, d_k / allowed if allowed else 0.0)
    del kern, plain
    with ctx():
        _, kern32 = leaf_grads(cfg32, p32, tokens, "auto")
    for i, (k, e) in enumerate(zip(kern32, exact)):
        norm, err = float(e.norm()), float((k - e).norm())
        check(err <= TRAIN_F32_TOL * norm, f"{name}: f32 leaf {i} "
              f"{tuple(k.shape)} {err:.3g} of norm {norm:.3g}")
        worst_f32 = max(worst_f32, err / norm if norm else 0.0)
    out.update(bf16_worst_share_of_budget=worst_budget,
               f32_worst_err_of_norm=worst_f32)
    if replay is not None:
        out.update(route_flips=replay["flips"], route_pairs=replay["pairs"])
    return out


def train_timing(step, state, batch, layers, kernels, kernel,
                 profile: bool) -> dict:
    """Wall ms of TRAIN_TIMED synchronized steps after a warm-up (each from
    the same state), launches of ``kernel`` over them, the peak and, with
    ``profile``, a profile of one step: the device's busy share and
    ``kernel``'s share. The RFF step, whose 37k launches cost the profiler
    42-47 s on the H100, is not profiled."""
    t_start = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    wall = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = path_launches(kernels, (kernel,))[kernel]
    check(launches == layers * TRAIN_MICRO * TRAIN_TIMED,
          f"{kernel}: {launches} launches in {TRAIN_TIMED} steps, not "
          f"{layers} x {TRAIN_MICRO} x {TRAIN_TIMED}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(wall))
    out = {"step_ms": ms, "step_ms_runs": wall,
           "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
           "peak_gib": peak, "launches": launches,
           "seconds": {"steps": time.perf_counter() - t_start}}
    if not profile:
        return out
    t_prof = time.perf_counter()
    busy = device_busy(lambda: step(state, batch), named="flash")
    out["seconds"]["profile"] = time.perf_counter() - t_prof
    return {**out, "device_ms": busy["device_ms"],
            "busy_share": busy["device_ms"] / ms,
            "kernel_device_ms": sum(d for _, d, _ in busy["named"]),
            "kernel_share_of_busy": sum(d for _, d, _ in busy["named"])
            / busy["device_ms"],
            "kernel_launches_in_profile": sum(n for _, _, n in busy["named"]),
            "device_launches": busy["kernel_launches"], "top": busy["top"]}


def recompute_ms(op, shape, dtype, device) -> float:
    """ms of one backward of the kernel's autograd Function (the plain
    version's recompute and its gradient) at ``shape``: the time of a
    forward and backward less the forward's."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(0)
    bh, slen, dh, dv = shape
    xs = [torch.randn(bh, slen, w, generator=gen, device=device)
          for w in (dh, dh, dv)]
    if op == "rff":
        xs[0], xs[1] = xs[0].abs() * 0.1, xs[1].abs() * 0.1
    xs = [x.to(dtype).requires_grad_() for x in xs]
    g = torch.randn(bh, slen, dv, generator=gen, device=device).to(dtype)
    call = ops.flash_attention if op == "flash" else ops.rff_attention

    def both():
        torch.autograd.grad(call(*xs, mode="cuda"), xs, g)

    with torch.no_grad():
        fwd = time_ms(lambda: call(*xs, mode="cuda"), reps=10)
    return time_ms(both, reps=10) - fwd


def train_resume(name, cfg, step_fn, batch_fn, device) -> dict:
    """A Trainer of TRAIN_RESUME[0] steps straight against one of
    TRAIN_RESUME[1] steps, a new Trainer resuming from its checkpoint and
    the rest: every leaf bit for bit, under deterministic()."""
    import shutil

    from repro_torch.optim.tree import leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    from repro_torch.train import checkpoint as ckpt_lib

    total, cut = TRAIN_RESUME
    shutil.rmtree(TRAIN_DIR / name, ignore_errors=True)
    io = {"save": [], "restore": []}
    originals = {k: getattr(ckpt_lib, k) for k in io}

    def timed(kind):
        def call(*args, **kw):
            t = time.perf_counter()
            out = originals[kind](*args, **kw)
            io[kind].append(time.perf_counter() - t)
            return out
        return call

    def trainer(steps, run):
        return Trainer(cfg, TrainerConfig(
            total_steps=steps, ckpt_every=10 ** 6,
            ckpt_dir=str(TRAIN_DIR / name / run),
            num_microbatches=TRAIN_MICRO, log_every=10 ** 6),
            batch_fn, step_fn=step_fn, device=device)

    t0 = time.perf_counter()
    for kind in io:
        setattr(ckpt_lib, kind, timed(kind))
    try:
        with deterministic():
            straight = trainer(total, "a")
            last = straight.run()
            state_a = straight.state
            del straight
            trainer(cut, "b").run()
            resumed = trainer(total, "b")
            resumed.run()
            check(len(resumed.step_times) == total - cut,
                  f"{name}: the resumed run took {len(resumed.step_times)} "
                  f"steps, not {total - cut}")
    finally:
        for kind, fn in originals.items():
            setattr(ckpt_lib, kind, fn)
    ckpt_bytes = sum(p.stat().st_size for p in (TRAIN_DIR / name / "a")
                     .glob("step_*.ckpt"))
    same = all(torch.equal(a, b) for a, b in zip(leaves(state_a),
                                                  leaves(resumed.state)))
    check(same, f"{name}: {total} steps straight differ from {cut} + resume "
          f"+ {total - cut}")
    shutil.rmtree(TRAIN_DIR / name, ignore_errors=True)
    return {"bitwise": same, "steps": total, "resumed_at": cut,
            "final_loss": last["loss"], "checkpoint_bytes": ckpt_bytes,
            "save_seconds": io["save"], "restore_seconds": io["restore"],
            "seconds": time.perf_counter() - t0}


def train_model(name, cfg, seed, device, kernels, kernel) -> dict:
    """(a) or (b): the loss hold, the gradient holds, timing, the RFF
    buffers' decay (b), and the resume."""
    from dataclasses import replace

    from repro_torch.data.lm_data import batch_at_step
    from repro_torch.models import lm_loss
    from repro_torch.optim import schedules
    from repro_torch.train.steps import init_train_state, make_train_step

    lr = functools.partial(schedules.warmup_cosine, **TRAIN_LR)

    def batch_fn(step):
        return {"tokens": batch_at_step(seed, step, global_batch=TRAIN_B,
                                        seq_len=TRAIN_S,
                                        vocab=cfg.vocab_size, device=device)}

    report = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, cfg, device=device)
    batch = batch_fn(0)
    step = make_train_step(cfg, num_microbatches=TRAIN_MICRO,
                           lr_schedule=lr)
    reset_launches(kernels)
    state1, metrics = step(state, batch)
    launched = path_launches(kernels, (kernel,))
    check(launched[kernel] == cfg.num_layers * TRAIN_MICRO,
          f"{name}: {launched[kernel]} launches in a step")
    loss_k = float(metrics["loss"])
    with torch.no_grad():
        mb = TRAIN_B // TRAIN_MICRO
        loss_p = sum(float(lm_loss(state["params"], cfg,
                                   tokens=batch["tokens"][i * mb:(i + 1) * mb],
                                   kernel_mode="ref"))
                     for i in range(TRAIN_MICRO)) / TRAIN_MICRO
    check(np.isfinite(loss_k) and abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          f"{name}: kernel loss {loss_k} vs plain {loss_p}")
    report.update(loss_kernel=loss_k, loss_plain=loss_p,
                  grad_norm=float(metrics["grad_norm"]),
                  launches_first_step=launched[kernel])
    if cfg.attention == "rff":
        # The feature buffers: zero gradient, AdamW's decay only, the same
        # bits on both paths (from state1, where lr > 0).
        new_k, m_k = step(state1, batch_fn(1))
        new_p, _ = make_train_step(cfg, num_microbatches=TRAIN_MICRO,
                                   lr_schedule=lr, kernel_mode="ref")(
            state1, batch_fn(1))
        rate = float(m_k["lr"])
        for old, got, plain in zip(state1["params"]["blocks"],
                                   new_k["params"]["blocks"],
                                   new_p["params"]["blocks"]):
            p = old["attn"]["omega"]
            want = p - m_k["lr"] * (torch.zeros_like(p) + 0.1 * p)
            check(torch.equal(got["attn"]["omega"], want)
                  and torch.equal(plain["attn"]["omega"], want),
                  f"{name}: omega did not decay by lr * 0.1 exactly")
            check(torch.equal(got["attn"]["bias"], old["attn"]["bias"]),
                  f"{name}: the feature bias moved")
        report["omega_decay"] = {"lr": rate, "factor": 1 - rate * 0.1,
                                 "bitwise_both_paths": True}
        del new_k, new_p
    del state1
    report["seconds_holds_loss"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut = replace(cfg, num_layers=TRAIN_GRAD_LAYERS)
    pcut = dict(state["params"],
                blocks=state["params"]["blocks"][:TRAIN_GRAD_LAYERS])
    report["grads"] = {"layers": TRAIN_GRAD_LAYERS, **grad_budget(
        name, cut, pcut, batch["tokens"][:TRAIN_B // TRAIN_MICRO])}
    del pcut
    torch.cuda.empty_cache()
    report["seconds_holds_grads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["timing"] = train_timing(step, state, batch, cfg.num_layers,
                                    kernels, kernel,
                                    profile=kernel == "flash_attention")
    bh = TRAIN_B // TRAIN_MICRO * cfg.padded_heads
    dh = cfg.resolved_head_dim
    shape = ((bh, TRAIN_S, dh, dh) if kernel == "flash_attention"
             else (bh, TRAIN_S, cfg.rff_num_features, dh))
    back = recompute_ms("flash" if kernel == "flash_attention" else "rff",
                        shape, cfg.activation_dtype
                        if kernel == "flash_attention" else torch.float32,
                        device)
    per_step = back * cfg.num_layers * TRAIN_MICRO
    report["timing"].update(recompute_ms_per_call=back,
                            recompute_shape=list(shape),
                            recompute_share_of_step=per_step
                            / report["timing"]["step_ms"])
    report["seconds_timing"] = time.perf_counter() - t0
    if kernel == "flash_attention":  # phase 23 (a) on this state
        LAUNCH["train"] = launch_train_hold(cfg, state, batch, lr, kernels,
                                            device)
    del state
    torch.cuda.empty_cache()
    if kernel == "flash_attention":
        report["nondeterministic_backward"] = nondeterministic_ops(cfg,
                                                                   device)
    report["resume"] = train_resume(name, cfg, step, batch_fn, device)
    torch.cuda.empty_cache()
    return report


def train_deepseek(seed, device, kernels) -> dict:
    """(c): deepseek-v2-lite-16b cut to TRAIN_DS_LAYERS layers, two train
    steps (MLA through kernel 11, the MoE's backward) and its gradient
    holds with the kernel run's routes replayed."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import batch_at_step
    from repro_torch.train.steps import init_train_state, make_train_step

    cfg = replace(get_config("deepseek-v2-lite-16b"),
                  num_layers=TRAIN_DS_LAYERS)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, cfg, device=device)
    step = make_train_step(cfg, num_microbatches=TRAIN_MICRO,
                           peak_lr=TRAIN_LR["peak_lr"])
    losses = []
    reset_launches(kernels)
    for i in range(2):
        batch = {"tokens": batch_at_step(seed, i, global_batch=TRAIN_DS_B,
                                         seq_len=TRAIN_S,
                                         vocab=cfg.vocab_size,
                                         device=device)}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        check(np.isfinite(losses[-1]), f"deepseek step {i}: loss "
              f"{losses[-1]}")
    launched = path_launches(kernels, ("flash_attention",))
    check(launched["flash_attention"] == TRAIN_DS_LAYERS * TRAIN_MICRO * 2,
          f"deepseek: {launched} in 2 steps")
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    grads = grad_budget("deepseek", cfg, params,
                        batch["tokens"][:TRAIN_DS_B // TRAIN_MICRO],
                        replay={})
    return {"layers": TRAIN_DS_LAYERS, "published_layers": 27,
            "B": TRAIN_DS_B, "S": TRAIN_S, "losses": losses,
            "launches": launched["flash_attention"], "grads": grads}


def train_launcher(kernels) -> dict:
    """(d): ``python -m repro_torch.launch.train`` with TRAIN_LAUNCH (run
    through its ``main``), each step's loss recorded by wrapping the
    trainer's step."""
    import shutil

    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer as trainer_mod

    ckpt_dir = TRAIN_DIR / "launch"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = []
    original = trainer_mod.make_train_step

    def recording(*args, **kw):
        inner = original(*args, **kw)

        def step(state, batch):
            new, metrics = inner(state, batch)
            losses.append(float(metrics["loss"]))
            return new, metrics
        return step

    trainer_mod.make_train_step = recording
    reset_launches(kernels)
    t0 = time.perf_counter()
    try:
        launch_train.main(TRAIN_LAUNCH + ["--ckpt-dir", str(ckpt_dir)])
    finally:
        trainer_mod.make_train_step = original
    seconds = time.perf_counter() - t0
    launched = path_launches(kernels, ("flash_attention",))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    first = float(np.mean(losses[:TRAIN_WINDOW]))
    last = float(np.mean(losses[-TRAIN_WINDOW:]))
    check(len(losses) == 200 and last < first,
          f"launcher: mean loss first {first}, last {last} over "
          f"{len(losses)} steps")
    return {"argv": TRAIN_LAUNCH, "steps": len(losses),
            "mean_loss_first_20": first, "mean_loss_last_20": last,
            "seconds": seconds, "launches": launched["flash_attention"]}


def phase_lm_train(seed, device, kernels) -> dict:
    """Phase 22: (a) qwen2-0.5b as published, (b) with RFF attention, (c)
    deepseek at TRAIN_DS_LAYERS layers, (d) the launcher. Returns the
    path's launches."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models import with_rff_attention

    t_phase = time.perf_counter()
    total: dict = {}
    cfg = get_config(TRAIN_ARCH)
    for name, model, kernel in (
            ("gqa", cfg, "flash_attention"),
            ("rff", with_rff_attention(cfg), "rff_linear_attention")):
        t0 = time.perf_counter()
        report = train_model(f"{TRAIN_ARCH} {name}", model, seed + 25, device,
                             kernels, kernel)
        add_launches(total, {kernel: report["launches_first_step"]
                             + report["timing"]["launches"]})
        emit({"phase": "lm_train", "arch": TRAIN_ARCH, "attention": name,
              "B": TRAIN_B, "S": TRAIN_S, "microbatches": TRAIN_MICRO,
              "lr": TRAIN_LR, **report,
              "seconds": time.perf_counter() - t0, "card": SMI})
    t0 = time.perf_counter()
    ds = train_deepseek(seed + 26, device, kernels)
    add_launches(total, {"flash_attention": ds["launches"]})
    emit({"phase": "lm_train", "arch": "deepseek-v2-lite-16b", **ds,
          "seconds": time.perf_counter() - t0, "card": SMI})
    torch.cuda.empty_cache()
    launcher = train_launcher(kernels)
    add_launches(total, {"flash_attention": launcher["launches"]})
    emit({"phase": "lm_train", "launcher": launcher, "card": SMI})
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_train_total", "seconds": seconds, "launches": total,
          "card": SMI})
    return total

# ---------------------------------------------------------------------------
# Phase 23 (launch): the launch layer on the card
# ---------------------------------------------------------------------------

# (a) runs inside phase 22 on its qwen2-0.5b GQA state and batch, (b) inside
# phase 21 on its deepseek-v2-lite-16b weights (no second 30 GiB model),
# each on a one-rank ("data", "model") = (1, 1) DeviceMesh over NCCL whose
# group is destroyed after it; (c) the dry-run of LAUNCH_ARCHS' four shapes
# on the single-pod mesh runs in subprocesses on the host's CPU (a fake
# process group of 256 ranks, no card), started when phase 22 starts and
# read after it. The phase states LAUNCH_SECONDS as its target (not a
# limit): the seconds of (a), (b) and the wait for (c).
LAUNCH_ARCHS = ("qwen2-0.5b", "deepseek-v2-lite-16b")
LAUNCH_SECONDS = 30.0
LAUNCH_DIR = ROOT / "build" / "launch_dryrun"
LAUNCH: dict = {}  # the records (a) and (b) leave for phase_launch


@contextlib.contextmanager
def one_rank_mesh(device):
    """A ("data", "model") = (1, 1) DeviceMesh on a one-rank process group
    (NCCL on the card, gloo on the CPU) at a free localhost port, destroyed
    on exit."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type=device.type)
    finally:
        dist.destroy_process_group()


def _full(t):
    """A DTensor's whole tensor; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def launch_train_hold(cfg, state, batch, lr, kernels, device) -> dict:
    """(a) The train step with the state as DTensors on the (1, 1) mesh,
    params placed by param_specs and moments by moment_specs of the
    train_4k cell, batch_axes from train_batch_axes and grad_specs the
    param placements, against the same step on the plain state, both under
    deterministic(): every leaf and metric bit for bit, kernel 11 launched
    through the DTensor boundary once a layer a microbatch."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding, specs
    from repro_torch.optim.optimizers import AdamWState
    from repro_torch.optim.tree import leaves
    from repro_torch.train.steps import make_train_step

    t0 = time.perf_counter()
    rcfg, note = specs.resolve_cell(cfg, SHAPES["train_4k"])
    cell = ShapeSpec("train", TRAIN_S, TRAIN_B, "train")
    with one_rank_mesh(device) as mesh:
        baxes = specs.train_batch_axes(rcfg, cell, mesh)
        pinned = replace(rcfg, activation_batch_axes=baxes)
        pspec = sharding.param_specs(pinned, mesh, state["params"])
        mspec = sharding.moment_specs(pinned, mesh, state["params"])
        dstate = {"params": sharding.distribute(state["params"], mesh, pspec),
                  "opt": AdamWState(
                      m=sharding.distribute(state["opt"].m, mesh, mspec),
                      v=sharding.distribute(state["opt"].v, mesh, mspec),
                      count=state["opt"].count),
                  "step": state["step"]}
        sharded = sum(any(type(p).__name__ != "Replicate"
                          for p in t.placements)
                      for t in leaves(dstate["opt"].m))
        step = make_train_step(pinned, num_microbatches=TRAIN_MICRO,
                               lr_schedule=lr, batch_axes=baxes,
                               grad_specs=pspec)
        with deterministic():
            reset_launches(kernels)
            t1 = time.perf_counter()
            new, metrics = step(dstate, batch)
            got = [_full(t) for t in leaves(new)]
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t1
            launched = path_launches(kernels, ("flash_attention",))
            del dstate, new
            t1 = time.perf_counter()
            want_state, want_m = make_train_step(
                cfg, num_microbatches=TRAIN_MICRO, lr_schedule=lr)(state,
                                                                   batch)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        want = leaves(want_state)
        same = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        same_m = all(torch.equal(_full(metrics[k]), want_m[k])
                     for k in want_m)
    check(same and same_m, "launch (a): the DTensor train step differs from "
          "the plain step")
    check(launched["flash_attention"] == cfg.num_layers * TRAIN_MICRO,
          f"launch (a): {launched} kernel 11 launches through the DTensor "
          f"boundary, not {cfg.num_layers} x {TRAIN_MICRO}")
    return {"arch": cfg.name, "policy": note, "mesh": [1, 1],
            "batch_axes": list(baxes), "bitwise": True,
            "leaves": len(got), "launches": launched["flash_attention"],
            "step_ms_dtensor": sharded_s * 1e3, "step_ms_plain": plain_s * 1e3,
            "seconds": time.perf_counter() - t0,
            "sharded_moment_leaves": sharded}


def launch_prefill_hold(cfg, params, seed, kernels, device) -> dict:
    """(b) The prefill at FAM_B x FAM_S with the weights as DTensors on the
    (1, 1) mesh under the prefill_32k cell's layout, against the same
    prefill on the plain weights: the logits bit for bit, kernel 11 (the
    MLA shape) launched through the DTensor boundary once a layer. Both
    run under no_grad: under inference_mode DTensor decomposes the MoE's
    one_hot into an op it has no rule for (aten._assert_async.msg)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import sharding, specs
    from repro_torch.train.steps import make_prefill_step

    t0 = time.perf_counter()
    rcfg, note = specs.resolve_cell(cfg, SHAPES["prefill_32k"])
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (FAM_B, FAM_S), generator=gen,
                           device=device)
    with torch.no_grad():
        want = make_prefill_step(rcfg)(params, {"tokens": tokens})
    with one_rank_mesh(device) as mesh:
        dparams = sharding.distribute(params, mesh,
                                      sharding.param_specs(rcfg, mesh,
                                                           params))
        reset_launches(kernels)
        t1 = time.perf_counter()
        with torch.no_grad():
            got = _full(make_prefill_step(rcfg)(dparams,
                                                {"tokens": tokens}))
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t1
        launched = path_launches(kernels, ("flash_attention",))
        del dparams
    check(torch.equal(got, want), "launch (b): the DTensor prefill differs "
          f"from the plain prefill by {max_err(got, want):.3g}")
    check(launched["flash_attention"] == cfg.num_layers,
          f"launch (b): {launched} kernel 11 launches, not {cfg.num_layers}")
    return {"arch": cfg.name, "policy": note, "mesh": [1, 1], "B": FAM_B,
            "S": FAM_S, "bitwise": True, "launches":
            launched["flash_attention"], "prefill_ms_dtensor": sharded_s * 1e3,
            "seconds": time.perf_counter() - t0}


def launch_dryrun_start() -> list:
    """(c) Start ``python -m repro_torch.launch.dryrun`` for each of
    LAUNCH_ARCHS (its four shapes, the single-pod mesh) on the CPU, one
    process an arch at low priority, the card hidden from them."""
    import shutil

    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch in LAUNCH_ARCHS:
        log = open(LAUNCH_DIR / f"{arch}.log", "w")
        procs.append((arch, log, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--out", str(LAUNCH_DIR)], cwd=str(ROOT), env=env,
            stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10))))
    return procs


def launch_dryrun_read(procs) -> tuple[list, dict, float]:
    """(c) Wait for the dry-run processes; each cell's per-rank bytes
    against the card's memory and its dominant roofline term. Returns
    (cells, each process's seconds, the wait's seconds)."""
    from repro_torch.configs import SHAPES
    from repro_torch.roofline import HW

    t0 = time.perf_counter()
    card = torch.cuda.get_device_properties(0).total_memory
    run_s = {}
    for arch, log, started, proc in procs:
        rc = proc.wait(timeout=900)
        run_s[arch] = time.perf_counter() - started
        log.close()
        tail = (LAUNCH_DIR / f"{arch}.log").read_text()[-3000:]
        check(rc == 0, f"launch (c): the dry-run of {arch} failed:\n{tail}")
    wait_s = time.perf_counter() - t0
    cells = []
    for arch in LAUNCH_ARCHS:
        for shape in SHAPES:
            rec = json.loads((LAUNCH_DIR / f"{arch}__{shape}__single.json")
                             .read_text())
            mem, roof = rec["memory"], rec["roofline"]
            cells.append({
                "arch": arch, "shape": shape, "policy": rec["policy"],
                "mesh": rec["mesh"], "run_s": rec["run_s"],
                "argument_gib": mem["argument_bytes"] / 2 ** 30,
                "output_gib": mem["output_bytes"] / 2 ** 30,
                "peak_gib": mem["peak_bytes"] / 2 ** 30,
                "card_gib": card / 2 ** 30,
                "fits": mem["peak_bytes"] <= card,
                "dominant": roof["dominant"], "compute_s": roof["compute_s"],
                "memory_s": roof["memory_s"],
                "collective_s": roof["collective_s"],
                "roofline_fraction": roof["roofline_fraction"],
                "collective_breakdown": rec["cost"]["collective_breakdown"],
                "flops_per_rank": rec["cost"]["flops_per_device"]})
            c = cells[-1]
            print(f"launch dryrun {arch} {shape} (16x16, 256 ranks): peak "
                  f"{c['peak_gib']:.2f} GiB a rank of {c['card_gib']:.1f} "
                  f"({'fits' if c['fits'] else 'does not fit'}), dominant "
                  f"{c['dominant']} (compute {c['compute_s']:.3e} s, memory "
                  f"{c['memory_s']:.3e} s, collective "
                  f"{c['collective_s']:.3e} s); HW {HW()} for {SMI}")
    return cells, run_s, wait_s


def phase_launch(procs) -> dict:
    """Phase 23: reads (c) and prints the phase's line with (a) and (b).
    Returns the path's launches (kernel 11 through the DTensor
    boundary)."""
    from repro_torch.roofline import HW

    check("train" in LAUNCH and "prefill" in LAUNCH,
          "launch: phases 21 and 22 did not run (a) and (b)")
    cells, run_s, wait_s = launch_dryrun_read(procs)
    seconds = {"a_train": LAUNCH["train"]["seconds"],
               "b_prefill": LAUNCH["prefill"]["seconds"],
               "c_wait": wait_s, "c_processes": run_s}
    total = seconds["a_train"] + seconds["b_prefill"] + wait_s
    emit({"phase": "launch", "a_train": LAUNCH["train"],
          "b_prefill": LAUNCH["prefill"],
          "c_dryrun": {"cells": cells, "hw": dataclasses.asdict(HW())},
          "seconds": {**seconds, "total": total},
          "target_seconds": LAUNCH_SECONDS, "card": SMI})
    return {"flash_attention": LAUNCH["train"]["launches"]
            + LAUNCH["prefill"]["launches"]}


# Phase 24: KRLS served at D = 1024 on the compact route: the paper's
# section 6 settings at the width repro's TPU kernel budgets one tenant's P
# for (src/repro/kernels/rff_krls_step.py:23-25; 4 MiB a tenant, 4 GiB the
# bank). The float64 run takes the first K_WIDE_F64_TENANTS tenants (rows
# are independent); the phase's target is K_WIDE_SECONDS.
K_WIDE_D_FEAT, K_WIDE_F64_TENANTS = 1024, 64
K_WIDE_ROUNDS, K_WIDE_SECONDS = 6, 60.0


def phase_krls_wide_server(seed, device, kernels) -> tuple[dict, dict]:
    """make_server("krls", bank=1024, chunk=16) at D = 1024 (d = 5, sigma
    = 5, lam = 1e-4, beta = 0.9995): a ragged stream of K_WIDE_ROUNDS
    rounds (flush and drain in turns), (1024, 64) block reads and
    single-tenant reads through kernel 3, a make_tick("krls") tier (the
    compact step),
    against the same server with mode="ref" on the card and within the f32
    budget of a float64 run of the first K_WIDE_F64_TENANTS tenants. Every
    flush and tick must take the compact route. Then the flush's shape
    (1024, 16, 5, 1024) is timed on the compact route, in turns with the
    streaming route forced on the same inputs, and its plain version.
    Returns (launches, the flush's timings)."""
    from repro_torch.kernels.rff_krls_step import rff_krls_bank_chunk_cuda
    from repro_torch.serve import make_server, make_tick

    nsub = K_WIDE_F64_TENANTS
    fm = family_map("rff", seed, K_D_IN, K_WIDE_D_FEAT, K_SIGMA, device)
    fm64 = f64_map(fm)
    hp = dict(chunk=CHUNK, lam=K_LAM, beta=K_BETA, device=device)
    servers = (make_server("krls", feature_map=fm, bank=BANK, **hp),
               make_server("krls", feature_map=fm, bank=BANK, mode="ref", **hp),
               make_server("krls", feature_map=fm64, bank=nsub, mode="ref",
                           **hp))
    ticks = [make_tick("krls", f, beta=K_BETA, mode=m)
             for f, m in ((fm, "auto"), (fm, "ref"), (fm64, "ref"))]
    rng = np.random.default_rng(seed + 24)
    xq = rng.normal(size=(BANK, Q, K_D_IN)).astype(np.float32)
    tick_x = rng.normal(size=(4, BANK, K_D_IN)).astype(np.float32)
    tick_y = np.sin(tick_x[..., 0]).astype(np.float32)

    reset_launches(kernels)
    t0 = t_phase = time.perf_counter()
    errs, mse, submits = [[] for _ in servers], [], 0
    for rnd, (tenants, xs, ys) in enumerate(ragged_stream(rng, K_WIDE_ROUNDS,
                                                          K_D_IN)):
        for i, srv in enumerate(servers):
            for t, x, y in zip(tenants.tolist(), xs, ys.tolist()):
                if i < 2 or t < nsub:
                    srv.submit(t, x, y)
        submits += len(tenants)
        res = [srv.drain() if rnd % 2 else srv.flush() for srv in servers]
        check(sorted(res[0]) == sorted(res[1])
              and sorted(res[2]) == [t for t in sorted(res[0]) if t < nsub],
              "wide krls servers served different tenants")
        for out, r in zip(errs, res):
            out.append(np.array([e for t in sorted(r) if t < nsub
                                 for _, e in r[t]]))
        mse.append(float(np.mean([e ** 2 for r in res[:1] for t in r
                                  for _, e in r[t]])))
    blocks = [srv.predict_block(xq[:srv.queue.num_tenants])
              for srv in servers]
    singles = [torch.stack([srv.predict(t, xq[t]) for t in (0, 1, nsub - 1)])
               for srv in servers]
    states = [srv.queue.state for srv in servers]
    for t in range(tick_x.shape[0]):
        for i, (tick, st) in enumerate(zip(ticks, states)):
            dt, n = st.theta.dtype, st.theta.shape[0]
            states[i], _ = tick(st, torch.from_numpy(tick_x[t, :n]).to(device, dt),
                                torch.from_numpy(tick_y[t, :n]).to(device, dt))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = path_launches(
        kernels, ("krls_bank_chunk", "krls_bank_step", "bank_predict"))
    routes = dict(kernels["krls_bank_chunk"].route_launches)
    step_routes = dict(kernels["krls_bank_step"].route_launches)
    check(routes["compact"] == launches["krls_bank_chunk"],
          f"krls flushes at D = {K_WIDE_D_FEAT} did not all take the compact "
          f"route: {routes}")
    check(step_routes["compact"] == launches["krls_bank_step"],
          f"krls ticks at D = {K_WIDE_D_FEAT} did not all take the compact "
          f"route: {step_routes}")
    srv = servers[0]
    flushes = srv.queue.flushes
    check(flushes >= 4, f"only {flushes} wide krls flushes")
    check(mse[-1] < mse[0], f"wide krls prior MSE did not fall: {mse}")
    check(all(torch.equal(s.snapshot.state.step[:nsub],
                          srv.snapshot.state.step[:nsub]) for s in servers),
          "wide krls tick counts differ")
    snaps = [s.snapshot.state for s in servers]
    sub = slice(0, nsub)
    prior = [torch.from_numpy(np.concatenate(e))[None] for e in errs]
    budget = {
        "prior_errors": within_budget("wide prior errors", *prior, normwise),
        "theta": within_budget("wide theta",
                               *[s.theta[sub] for s in snaps], normwise),
        "P": within_budget("wide P", *[s.pmat[sub] for s in snaps], p_rel),
        "predict_block": within_budget("wide predict_block",
                                       *[b[sub] for b in blocks], normwise),
        "predict": within_budget("wide predict", *singles, normwise),
        "tick_theta": within_budget("wide make_tick theta",
                                    *[s.theta[sub] for s in states], normwise),
        "tick_P": within_budget("wide make_tick P",
                                *[s.pmat[sub] for s in states], p_rel),
    }
    for got in (snaps[0].theta, snaps[0].pmat, blocks[0], states[0].pmat):
        check(bool(torch.isfinite(got).all()),
              "wide krls server output not finite")
    check(blocks[0].shape == (BANK, Q) and snaps[0].pmat.shape
          == (BANK, K_WIDE_D_FEAT, K_WIDE_D_FEAT), "wide krls shapes")
    ticked = [int(n) for n in srv.snapshot.state.step.tolist()]
    pmat_bytes = snaps[0].pmat.numel() * snaps[0].pmat.element_size()
    del servers, srv, snaps, states, blocks, singles, prior
    torch.cuda.empty_cache()

    # The flush's shape on the compact route, in turns with the streaming
    # route forced on the same inputs, and the plain version.
    k = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_WIDE_D_FEAT, device, "eye")
    case = timed_case(*krls_chunk_case(k), plain_reps=2)
    forced = turns(lambda r: rff_krls_bank_chunk_cuda(
        k["theta"], k["pmat"], k["xs"], k["ys"], k["w"], k["b"], k["beta"],
        None, k["s"], _route=r), ("compact", "streaming"), reps=5)
    del k
    torch.cuda.empty_cache()
    flush = {**{k_: case[k_] for k_ in ("ms", "ms_runs", "plain_ms",
                                         "plain_ms_runs", "bound_ms",
                                         "bound_by")},
             "library_ms": None,
             "turns_with_streaming_ms": forced["compact"],
             "streaming_forced_ms": forced["streaming"],
             "shape": [BANK, CHUNK, K_D_IN, K_WIDE_D_FEAT]}
    emit({"phase": "krls_wide_server", "bank": BANK, "d": K_D_IN,
          "D": K_WIDE_D_FEAT, "sigma": K_SIGMA, "lam": K_LAM, "beta": K_BETA,
          "chunk": CHUNK, "Q": Q, "submits": submits, "flushes": flushes,
          "ticks_per_tenant": {"min": min(ticked), "median":
                               float(np.median(ticked)), "max": max(ticked)},
          "prior_mse_per_round": mse, "launches": launches,
          "chunk_route_launches": routes, "step_route_launches": step_routes,
          "f64_tenants": nsub, "p_device_bytes": pmat_bytes,
          "budget": {"factor": BUDGET, "floor": BUDGET_FLOOR, **budget},
          "flush_times": flush, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "target_seconds": K_WIDE_SECONDS, "card": SMI})
    return launches, flush


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
    errs, predict_routes = phase_kernels(rng, device)
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
    # Every remaining LM arch (phase 21), with the LM slice.
    torch.cuda.empty_cache()
    fam_launches, fam_times = phase_lm_families(args.seed, device, kernels)
    add_launches(launches, fam_launches)
    # The LM training half (phase 22), after the serving archs, with the
    # launch layer's dry-run (phase 23 (c)) on the host meanwhile.
    torch.cuda.empty_cache()
    dryrun_procs = launch_dryrun_start()
    add_launches(launches, phase_lm_train(args.seed, device, kernels))
    # The launch layer (phase 23): (a) and (b) ran in phases 22 and 21.
    add_launches(launches, phase_launch(dryrun_procs))
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
    # KRLS served at D = 1024 on the compact route (phase 24), last.
    torch.cuda.empty_cache()
    wide_launches, wide_flush = phase_krls_wide_server(args.seed, device,
                                                        kernels)
    add_launches(launches, wide_launches)
    times["krls_bank_chunk"]["routes"]["compact"]["d1024"] = wide_flush
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
    measured = {"bank_predict": predict_routes,
                "flash_attention": flash_routes, **krls_routes}
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
         **({"mla": {k: fam_times["flash_mla"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_backend", "shape")}}
            if name == "flash_attention" else {}),
         **({"routes": routes[name]} if name in routes else {})}
        for name in replaces
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
