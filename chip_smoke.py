#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and:

1. prints the card's name and power limit and the build seconds;
2. holds each KLMS-slice kernel (KLMS chunk, KLMS step, bank predict)
   against its plain PyTorch version on the card, at the serving shapes
   and at ragged ones, and checks the bitwise contracts (a chunk of 16
   equals 16 steps, a chunk at T=1 equals a step, a masked tick leaves
   theta unchanged);
3. drives the KLMS main path: a ``make_server("klms")`` bank of 1024
   tenants with a d=128, D=2048 random-feature map and chunk=16 takes a
   ragged stream, flushes, drains and serves single-tenant and (1024, 64)
   block reads at f32 and bf16, and a ``make_tick`` lockstep tier ticks the
   bank; the kernel server is compared with the same server run with
   ``mode="ref"`` on the card, and each kernel's launch count must rise;
4. holds both KRLS kernels (chunk, step) against their plain versions at
   the serving shape (B=1024, d=5, D=300, T=16) and at ragged ones (D up
   to 1024, and a P that is not symmetric), with their bitwise contracts;
5. drives the KRLS main path: ``make_server("krls")`` at the paper's §6
   settings (d=5, D=300, sigma=5, lam=1e-4, beta=0.9995) with B=1024 and
   chunk=16, its reads and a ``make_tick("krls")`` tier, against the same
   server with ``mode="ref"`` and within the f32 error budget that a
   float64 run of the same stream measures;
6. times each kernel, its plain version and its bound.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failure exits non-zero. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
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

REPLACES = {
    "klms_bank_chunk": "src/repro/kernels/rff_klms_step.py:211",
    "klms_bank_step": "src/repro/kernels/rff_klms_step.py:80",
    "bank_predict": "src/repro/kernels/rff_predict.py:84",
    "krls_bank_chunk": "src/repro/kernels/rff_krls_step.py:262",
    "krls_bank_step": "src/repro/kernels/rff_krls_step.py:104",
}
SOURCES = {
    "klms_bank_chunk": "src/repro_torch/csrc/klms_bank.cu",
    "klms_bank_step": "src/repro_torch/csrc/klms_bank.cu",
    "bank_predict": "src/repro_torch/csrc/bank_predict.cu",
    "krls_bank_chunk": "src/repro_torch/csrc/krls_bank.cu",
    "krls_bank_step": "src/repro_torch/csrc/krls_bank.cu",
}
TOLERANCE = {"klms_bank_chunk": F32_TOL, "klms_bank_step": F32_TOL,
             "bank_predict": BF16_TOL, "krls_bank_chunk": F32_TOL,
             "krls_bank_step": F32_TOL}


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
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "shapes": shapes, "max_abs_err": errs,
          "tolerance": {"f32": F32_TOL, "bf16_predict": BF16_TOL},
          "bitwise": {"chunk16_eq_16_steps": True, "chunk1_eq_step": True,
                      "masked_tick_noop": True}})
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


def reset_launches(kernels) -> None:
    for k in kernels.values():
        k.launches = 0


def path_launches(kernels, names) -> dict:
    """The launch counts of a path's kernels; each must have launched."""
    launches = {name: kernels[name].launches for name in names}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches


def phase_server(seed, device, kernels) -> dict:
    """The KLMS main path: make_server("klms") writes and reads,
    make_tick."""
    from repro_torch.features import rff_map
    from repro_torch.serve import make_server, make_tick

    fm = rff_map(torch.Generator().manual_seed(seed), D_IN, D_FEAT, SIGMA,
                 device=device)
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
    emit({"phase": "server", "bank": BANK, "d": D_IN, "D": D_FEAT,
          "chunk": CHUNK, "Q": Q, "submits": submits, "flushes": flushes,
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


def phase_krls_kernels(rng, device) -> tuple[dict, dict]:
    """Both KRLS kernels against their plain versions, and the bitwise
    contracts at the serving shape."""
    from repro_torch.kernels import ops

    names = ("krls_bank_chunk", "krls_bank_step")
    errs, shares, rels = (dict.fromkeys(names, 0.0) for _ in range(3))
    cases = [(BANK, K_D_IN, K_D_FEAT, CHUNK, "eye"),
             (BANK, K_D_IN, K_D_FEAT, CHUNK, "spd")]
    cases += [(*shape, "spd") for shape in K_RAGGED] + [(4, 5, 70, 6, "asym")]
    for bank, d, dfeat, tlen, kind in cases:
        a = krls_inputs(rng, bank, tlen, d, dfeat, device, kind)
        args = (a["theta"], a["pmat"], a["xs"], a["ys"], a["w"], a["b"],
                a["beta"], a["mask"], a["s"])
        sargs = (a["theta"], a["pmat"], a["xs"][:, 0].contiguous(),
                 a["ys"][:, 0].contiguous(), a["w"], a["b"], a["beta"], a["s"])
        for name, op, xargs in (("krls_bank_chunk", ops.rff_krls_bank_chunk, args),
                                ("krls_bank_step", ops.rff_krls_bank_step, sargs)):
            e, f, r = hold_krls(f"{name} {bank, d, dfeat, tlen} P={kind}",
                                op(*xargs, mode="cuda"),
                                op(*xargs, mode="ref"))
            errs[name] = max(errs[name], e)
            shares[name] = max(shares[name], f)
            rels[name] = max(rels[name], r)
        del a, args, sargs

    a = krls_inputs(rng, BANK, CHUNK, K_D_IN, K_D_FEAT, device, "spd")
    common = (a["w"], a["b"], a["beta"])
    chunk = ops.rff_krls_bank_chunk(a["theta"], a["pmat"], a["xs"], a["ys"],
                                    *common, None, a["s"], mode="cuda")
    check(torch.equal(chunk[1], chunk[1].transpose(1, 2)),
          "P' of a symmetric P is not exactly symmetric")
    theta, pmat = a["theta"], a["pmat"]
    for t in range(CHUNK):
        theta, pmat, pred, err = ops.rff_krls_bank_step(
            theta, pmat, a["xs"][:, t].contiguous(),
            a["ys"][:, t].contiguous(), *common, a["s"], mode="cuda")
        check(torch.equal(pred, chunk[2][:, t]) and torch.equal(err, chunk[3][:, t]),
              f"krls chunk of {CHUNK} vs steps: tick {t} outputs differ")
        if t == 0:
            one = ops.rff_krls_bank_chunk(
                a["theta"], a["pmat"], a["xs"][:, :1].contiguous(),
                a["ys"][:, :1].contiguous(), *common, None, a["s"],
                mode="cuda")
            check(all(torch.equal(u, v) for u, v in
                      zip(one, (theta, pmat, pred[:, None], err[:, None]))),
                  "krls chunk at T=1 vs step differ")
    check(torch.equal(theta, chunk[0]) and torch.equal(pmat, chunk[1]),
          f"krls chunk of {CHUNK} vs steps: theta or P differs")
    del chunk, theta, pmat, one
    masked = ops.rff_krls_bank_chunk(
        a["theta"], a["pmat"], a["xs"], a["ys"], *common,
        torch.zeros_like(a["ys"]), a["s"], mode="cuda")
    check(torch.equal(masked[0], a["theta"]) and torch.equal(masked[1], a["pmat"]),
          "masked krls ticks changed theta or P")
    check(masked[0].data_ptr() != a["theta"].data_ptr()
          and masked[1].data_ptr() != a["pmat"].data_ptr(),
          "theta' or P' aliases its input")
    prior = ops.rff_bank_predict(a["theta"], a["xs"], a["w"], a["b"], a["s"],
                                 mode="ref")
    hold("masked krls ticks emit the prior prediction", [masked[2]], [prior],
         F32_TOL)
    torch.cuda.synchronize()
    emit({"phase": "krls_kernels_vs_plain",
          "cases": [list(c) for c in cases], "max_abs_err": errs,
          "max_share_of_tolerance": shares, "p_rel_err": rels,
          "tolerance": {"theta_pred_err": F32_TOL, "p_of_max_abs_p": P_TOL},
          "bitwise": {"chunk16_eq_16_steps": True, "chunk1_eq_step": True,
                      "masked_tick_noop_fresh_outputs": True,
                      "p_out_exactly_symmetric": True}})
    return errs, rels


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


def phase_krls_server(seed, device, kernels) -> dict:
    """The KRLS main path: make_server("krls") writes and reads,
    make_tick("krls"); held against mode="ref" and a float64 run."""
    from repro_torch.features import rff_map
    from repro_torch.serve import make_server, make_tick

    fm = rff_map(torch.Generator().manual_seed(seed), K_D_IN, K_D_FEAT,
                 K_SIGMA, device=device)
    fm64 = type(fm)(*(t.double() for t in fm))
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
    emit({"phase": "krls_server", "bank": BANK, "d": K_D_IN, "D": K_D_FEAT,
          "sigma": K_SIGMA, "lam": K_LAM, "beta": K_BETA, "chunk": CHUNK,
          "Q": Q, "submits": submits, "flushes": flushes,
          "prior_mse_per_round": mse, "staleness": srv.staleness,
          "launches": launches, "seconds": seconds,
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


def phase_times(rng, device) -> dict:
    """Kernel, plain version and bound at the serving shapes.

    Operations count the projection's 2 d D multiply-adds per row and, per
    feature, bias add, cos (as one operation), scale, the theta . z
    multiply-add and, for KLMS, the update's multiply-add: a lower bound,
    since a cosf takes tens of instructions. A KRLS tick adds, per tenant,
    2 D^2 for P z, 5 D^2 for the downdate and its symmetrization, and 5 D
    for z . pz, the gain and the theta update (every tick of the timed
    chunk is live). Bytes count each input read once and each output
    written once: for KRLS, P in and P' out dominate.
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
    k_shared = 4 * (K_D_IN * K_D_FEAT + 2 * K_D_FEAT)
    k_state = 4 * 2 * BANK * (K_D_FEAT ** 2 + K_D_FEAT)  # theta, P in and out
    k_tick = 2 * K_D_IN * K_D_FEAT + 7 * K_D_FEAT ** 2 + 12 * K_D_FEAT
    cases["krls_bank_chunk"] = (
        lambda m: ops.rff_krls_bank_chunk(
            k["theta"], k["pmat"], k["xs"], k["ys"], k["w"], k["b"],
            k["beta"], None, k["s"], mode=m),
        k_shared + k_state + 4 * (BANK * CHUNK * (K_D_IN + 3) + BANK),
        BANK * CHUNK * k_tick,
    )
    cases["krls_bank_step"] = (
        lambda m: ops.rff_krls_bank_step(
            k["theta"], k["pmat"], kx0, ky0, k["w"], k["b"], k["beta"],
            k["s"], mode=m),
        k_shared + k_state + 4 * (BANK * (K_D_IN + 3) + BANK),
        BANK * k_tick,
    )
    out = {}
    for name, (fn, nbytes, nops) in cases.items():
        # Plain, kernel, kernel, plain: two readings each, within one call.
        plain = [time_ms(lambda: fn("ref"))]
        kern = [time_ms(lambda: fn("cuda")), time_ms(lambda: fn("cuda"))]
        plain.append(time_ms(lambda: fn("ref")))
        bound, bound_by = bound_ms(nbytes, nops)
        out[name] = dict(ms=min(kern), plain_ms=min(plain), bound_ms=bound,
                         bound_by=bound_by, bytes=nbytes, ops=nops,
                         ms_runs=kern, plain_ms_runs=plain)
    bf16 = [time_ms(lambda: ops.rff_bank_predict(
        a["theta"], xq, a["w"], a["b"], a["s"], mode=m, precision="bf16"))
        for m in ("ref", "cuda")]
    emit({"phase": "times", "shapes": {"B": BANK, "T": CHUNK, "d": D_IN,
                                       "D": D_FEAT, "Q": Q},
          "krls_shapes": {"B": BANK, "T": CHUNK, "d": K_D_IN, "D": K_D_FEAT},
          "kernels": out,
          "bank_predict_bf16": {"plain_ms": bf16[0], "ms": bf16[1]},
          "library_ms": "null: no single PyTorch call computes any of the "
                        "five functions"})
    return out


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
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
        rff_krls_bank_step_cuda)))
    errs = phase_kernels(rng, device)
    launches = phase_server(args.seed, device, kernels)
    krls_errs, p_rels = phase_krls_kernels(rng, device)
    errs.update(krls_errs)
    krls_launches = phase_krls_server(args.seed, device, kernels)
    launches["bank_predict"] += krls_launches.pop("bank_predict")
    launches.update(krls_launches)
    times = phase_times(rng, device)
    torch.cuda.synchronize()
    print(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "tolerance": TOLERANCE[name],
         **({"p_rel_err": p_rels[name], "p_tolerance": P_TOL}
            if name in p_rels else {}),
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": None}
        for name in REPLACES
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
