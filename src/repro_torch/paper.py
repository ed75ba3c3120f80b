"""The paper's figures and table 1 on the card (``benchmarks/paper.py``'s
counterpart).

Each figure function returns ``repro``'s ``(us_per_call, derived,
detail)``: ``us_per_call`` the mean per-sample time of the headline
algorithm, ``derived`` the figure's headline quantity. The Monte-Carlo
realizations of a figure share one feature map, so they run as one bank
of ``runs`` tenants: RFF-KLMS through ``klms_bank_run(chunk=)`` (the KLMS
chunk kernel), RFF-KRLS through ``krls_bank_run(chunk=)`` (the KRLS chunk
kernel), QKLMS and ALD-KRLS through the generic ``bank_run``, so both
sides of each comparison are batched over runs. Data is drawn on the
device from ``seed``. Times come from CUDA events around one call after a
warm-up call on the first samples (the host clock on the CPU).

``check_ref=True`` runs every RFF side a second time with ``mode="ref"``
(the plain PyTorch versions) on the same realizations and reports the
relative difference of the tail MSEs and the largest difference of any
prior error of any run, relative to the largest prior error. RFF-KRLS at
the paper's lam = 1e-4 is where f32 itself is the limit, so fig. 2b also
runs the plain version in float64 and reports both f32 paths' distance
from it, on the same scale.

On the card the QKLMS and ALD sides are also timed as one CUDA graph of
``GRAPH_TICKS`` ticks of the generic bank loop (``us_*_graph``): the
loop's device time a sample without the host's launch cost, beside its
wall time (``us_*``), which the host's launches of a few tens of small
kernels a tick set.

Run on the card: ``python -m repro_torch.paper`` (every figure at the
run counts of ``configs/paper_rff.EXPERIMENTS``, one JSON line each).
:func:`krls_f32_horizon`, which sets fig. 2b's length, is called on its
own.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_rff import EXPERIMENTS
from repro_torch.core.adaptive import monte_carlo_mse
from repro_torch.core.bank import (
    bank_init,
    bank_run,
    klms_bank_run,
    krls_bank_run,
)
from repro_torch.core.learner import ald_krls_learner, qklms_learner
from repro_torch.core.rff import gaussian_kernel, kernel_estimate, sample_rff
from repro_torch.core.theory import rzz_closed_form, steady_state_mse
from repro_torch.data.synthetic import (
    gen_chaotic1,
    gen_chaotic2,
    gen_kernel_expansion,
    gen_nonlinear_wiener,
)

__all__ = [
    "klms_realizations",
    "krls_realizations",
    "qklms_realizations",
    "ald_realizations",
    "fig1_convergence",
    "fig2a_klms_vs_qklms",
    "fig2b_krls",
    "fig3a_chaotic1",
    "fig3b_chaotic2",
    "table1_timing",
    "table1_highdim",
    "orf_vs_iid",
    "krls_f32_horizon",
    "run_all",
]

CHUNK = 512  # ticks per chunk launch of the RFF realizations
WARM_SAMPLES = 32  # samples of the warm-up call before a timed one
GRAPH_TICKS = 256  # ticks of the generic bank loop in one timed CUDA graph
# Fig. 2b's stream length: repro's fig2b_krls default. Example 2's 15000
# samples are past the f32 horizon of the EW-RLS recursion at lam = 1e-4,
# beta = 0.9995: its runs depart from float64 and blow up after about 7000
# ticks (the kernel and the plain version alike; krls_f32_horizon measures
# it), so the figure's tail MSE there measures f32 overflow, not the
# filter.
FIG2B_SAMPLES = 3000


def klms_realizations(rff, xs, ys, mu, *, mode: str = "auto",
                      chunk: int = CHUNK):
    """RFF-KLMS over R realizations ``xs (R, n, d)``, ``ys (R, n)`` as one
    bank. Returns (final state, prior errors ``(R, n)``)."""
    state, out = klms_bank_run(rff, xs, ys, mu, mode=mode, chunk=chunk)
    return state, out.error


def krls_realizations(rff, xs, ys, lam=1e-4, beta=0.9995, *,
                      mode: str = "auto", chunk: int = CHUNK):
    """RFF-KRLS over R realizations as one bank (paper §6 settings by
    default)."""
    state, out = krls_bank_run(rff, xs, ys, lam, beta, mode=mode, chunk=chunk)
    return state, out.error


def _qklms(xs, sigma, mu, eps, capacity):
    return qklms_learner(xs.shape[-1], sigma, mu, eps, capacity=capacity,
                         dtype=xs.dtype, device=xs.device)


def _ald(xs, sigma, nu, capacity):
    return ald_krls_learner(xs.shape[-1], sigma, nu=nu, capacity=capacity,
                            dtype=xs.dtype, device=xs.device)


def qklms_realizations(xs, ys, sigma, mu, eps, capacity):
    """QKLMS over R realizations through the generic bank."""
    lrn = _qklms(xs, sigma, mu, eps, capacity)
    state, out = bank_run(lrn, bank_init(lrn, xs.shape[0]), xs, ys)
    return state, out.error


def ald_realizations(xs, ys, sigma, nu, capacity):
    """ALD-KRLS over R realizations through the generic bank."""
    lrn = _ald(xs, sigma, nu, capacity)
    state, out = bank_run(lrn, bank_init(lrn, xs.shape[0]), xs, ys)
    return state, out.error


def _seconds(fn: Callable, device: torch.device):
    """``fn()`` and its seconds: CUDA events on the card, else the host
    clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _timed(run: Callable, xs, ys):
    """``run(xs, ys) -> (state, errors)`` after a warm-up call on the first
    samples; returns (state, errors, seconds)."""
    run(xs[:, :WARM_SAMPLES].contiguous(), ys[:, :WARM_SAMPLES].contiguous())
    (state, errs), sec = _seconds(lambda: run(xs, ys), xs.device)
    return state, errs, sec


def _graph_us(lrn, state, xs, ys):
    """Device µs a sample of the generic bank loop from ``state``: its
    first ``GRAPH_TICKS`` ticks captured as one CUDA graph, replayed once
    to warm and once timed. None off the card. A tick's work does not
    depend on the data (fixed-capacity dictionaries), so the first ticks
    time every tick."""
    if xs.device.type != "cuda":
        return None
    xs = xs[:, :GRAPH_TICKS].contiguous()
    ys = ys[:, :GRAPH_TICKS].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture asks
        bank_run(lrn, state, xs, ys)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bank_run(lrn, state, xs, ys)
    graph.replay()
    _, sec = _seconds(graph.replay, xs.device)
    del graph
    return sec / xs.shape[:2].numel() * 1e6


def _tail(curve, k: int) -> float:
    return float(torch.mean(curve[-k:]))


def _median_run(errs, k: int) -> float:
    """The median over runs of each run's MSE over its last ``k`` ticks (a
    run whose errors are not finite counts as infinite)."""
    per_run = torch.mean(torch.square(errs[:, -k:].double()), dim=1)
    return float(torch.median(torch.nan_to_num(per_run, nan=math.inf)))


def _max_rel(got, want) -> float:
    """``max |got - want| / max |want|`` over every run and tick."""
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def _rff_side(name: str, run: Callable, xs, ys, tail: int,
              check_ref: bool, exact: Optional[Callable] = None) -> tuple:
    """An RFF side: its timed kernel run and, with ``check_ref``, the same
    realizations with ``mode="ref"`` and, given ``exact() -> float64
    prior errors``, both paths' distance from those. Returns (prior
    errors, seconds, detail)."""
    _, errs, sec = _timed(lambda x, y: run(x, y, "auto"), xs, ys)
    curve = monte_carlo_mse(errs)
    detail = {}
    if check_ref:
        _, ref_errs, ref_sec = _timed(lambda x, y: run(x, y, "ref"), xs, ys)
        got, want = _tail(curve, tail), _tail(monte_carlo_mse(ref_errs), tail)
        detail = {f"mse_{name}_ref": want, f"us_{name}_ref":
                  ref_sec / errs.numel() * 1e6,
                  f"ref_rel_{name}": abs(got - want) / abs(want),
                  f"ref_maxrel_{name}": _max_rel(errs, ref_errs)}
        if exact is not None:
            want64 = exact()
            detail[f"f64_maxrel_{name}"] = _max_rel(errs.double(), want64)
            detail[f"f64_maxrel_{name}_plain"] = _max_rel(ref_errs.double(),
                                                          want64)
    return errs, sec, detail


def _setup(seed: int, device, input_dim: int, rff_dim: int, sigma: float):
    """The figure's feature map (from ``seed``) and its data generator
    (``seed + 1``, on the device)."""
    dev = resolve_device(device)
    rff = sample_rff(torch.Generator().manual_seed(seed), input_dim, rff_dim,
                     sigma, device=dev)
    return rff, torch.Generator(device=dev).manual_seed(seed + 1)


def fig1_convergence(runs: int = 50, num_samples: int = 5000,
                     rff_dim: int = 1000, *, seed: int = 0, device="cuda",
                     check_ref: bool = False):
    """§5.1 / Fig. 1: RFF-KLMS on model (7); steady state vs Prop. 1.4.

    derived = measured steady-state MSE / theoretical prediction (~1).
    """
    rff, gen = _setup(seed, device, 5, rff_dim, 5.0)
    data = gen_kernel_expansion(gen, num_samples=num_samples, runs=runs)
    errs, sec, detail = _rff_side(
        "rffklms",
        lambda x, y, m: klms_realizations(rff, x, y, 1.0, mode=m),
        data.xs, data.ys, 500, check_ref)
    curve = monte_carlo_mse(errs)
    steady = _tail(curve, 500)
    theory = float(steady_state_mse(rzz_closed_form(rff, 1.0), 1.0, 0.1))
    detail.update(
        mse_at_500=float(torch.mean(curve[450:550])),
        mse_at_2000=float(torch.mean(curve[1950:2050])),
        steady_state_mse=steady, mse_rffklms=steady, theory_mse=theory,
        runs=runs, num_samples=num_samples,
    )
    return sec / (runs * num_samples) * 1e6, steady / theory, detail


def _klms_vs_qklms(gen_fn, input_dim, sigma, mu, eps, rff_dim, qcap, runs,
                   n, seed, device, check_ref):
    rff, gen = _setup(seed, device, input_dim, rff_dim, sigma)
    xs, ys = gen_fn(gen, runs)
    tail = max(n // 10, 50)
    errs_rff, t_rff, detail = _rff_side(
        "rffklms", lambda x, y, m: klms_realizations(rff, x, y, mu, mode=m),
        xs, ys, tail, check_ref)
    final_q, errs_q, t_q = _timed(
        lambda x, y: qklms_realizations(x, y, sigma, mu, eps, qcap), xs, ys)
    detail.update(
        us_rffklms=t_rff / (runs * n) * 1e6,
        us_qklms=t_q / (runs * n) * 1e6,
        us_qklms_graph=_graph_us(_qklms(xs, sigma, mu, eps, qcap), final_q,
                                 xs, ys),
        mse_rffklms=_tail(monte_carlo_mse(errs_rff), tail),
        mse_qklms=_tail(monte_carlo_mse(errs_q), tail),
        qklms_dict_size=int(final_q.size[0]),
        qklms_dict_mean=float(final_q.size.float().mean()),
        speedup=t_q / t_rff, runs=runs, num_samples=n,
    )
    return detail


def fig2a_klms_vs_qklms(runs: int = 25, num_samples: int = 15000, *,
                        seed: int = 0, device="cuda",
                        check_ref: bool = False):
    """§5.2 / Fig. 2a: RFF-KLMS (D = 300) vs QKLMS (eps = 5) on model (9).

    derived = MSE(RFF-KLMS) / MSE(QKLMS) at steady state (paper: ~1).
    """
    r = _klms_vs_qklms(
        lambda g, r_: gen_nonlinear_wiener(g, num_samples=num_samples,
                                           runs=r_),
        5, 5.0, 1.0, 5.0, 300, 256, runs, num_samples, seed, device,
        check_ref)
    return r["us_rffklms"], r["mse_rffklms"] / r["mse_qklms"], r


def fig3a_chaotic1(runs: int = 200, num_samples: int = 500, *, seed: int = 0,
                   device="cuda", check_ref: bool = False):
    """§5.3 / Fig. 3a: chaotic series 1, D = 100 vs QKLMS eps = 0.01."""
    r = _klms_vs_qklms(
        lambda g, r_: gen_chaotic1(g, num_samples=num_samples, runs=r_),
        2, 0.05, 1.0, 0.01, 100, 64, runs, num_samples, seed, device,
        check_ref)
    return r["us_rffklms"], r["mse_rffklms"] / r["mse_qklms"], r


def fig3b_chaotic2(runs: int = 200, num_samples: int = 1000, *,
                   seed: int = 0, device="cuda", check_ref: bool = False):
    """§5.4 / Fig. 3b: chaotic series 2, D = 100 vs QKLMS eps = 0.01."""
    r = _klms_vs_qklms(
        lambda g, r_: gen_chaotic2(g, num_samples=num_samples, runs=r_),
        2, 0.05, 1.0, 0.01, 100, 128, runs, num_samples, seed, device,
        check_ref)
    return r["us_rffklms"], r["mse_rffklms"] / r["mse_qklms"], r


def fig2b_krls(runs: int = 10, num_samples: int = 3000, *, seed: int = 0,
               device="cuda", check_ref: bool = False):
    """§6 / Fig. 2b: RFF-KRLS (D = 300, lam = 1e-4, beta = 0.9995) vs
    Engel's ALD-KRLS.

    nu = 5e-3 instead of the paper's 5e-4, as in ``repro``: the bordered
    inverse of the near-flat sigma = 5 kernel is f64-only at 5e-4. Even at
    5e-3 a few f32 ALD runs blow up (``repro``'s own CPU reading of this
    figure has an ALD MSE of 2e10). derived = MSE(RFF-KRLS) / MSE(ALD-KRLS)
    over all runs, as in ``repro`` (taken in float64; not finite when a
    run's errors are not), so those runs set it. The comparison of the
    typical run is ``median_run_ratio``: the ratio of the medians over runs
    of a run's tail MSE (``mse_*_median_run``).
    """
    rff, gen = _setup(seed, device, 5, 300, 5.0)
    xs, ys = gen_nonlinear_wiener(gen, num_samples=num_samples, runs=runs)
    rff64 = type(rff)(*(a.double() for a in rff))
    errs_r, t_r, detail = _rff_side(
        "rffkrls", lambda x, y, m: krls_realizations(rff, x, y, mode=m),
        xs, ys, 300, check_ref,
        exact=lambda: krls_realizations(rff64, xs.double(), ys.double(),
                                        mode="ref")[1])
    final_a, errs_a, t_a = _timed(
        lambda x, y: ald_realizations(x, y, 5.0, 5e-3, 128), xs, ys)
    mse_r = _tail(monte_carlo_mse(errs_r.double()), 300)
    mse_a = _tail(monte_carlo_mse(errs_a.double()), 300)
    med_r, med_a = _median_run(errs_r, 300), _median_run(errs_a, 300)
    detail.update(
        mse_rffkrls=mse_r, mse_aldkrls=mse_a,
        mse_rffkrls_median_run=med_r, mse_aldkrls_median_run=med_a,
        median_run_ratio=med_r / med_a,
        us_rffkrls=t_r / (runs * num_samples) * 1e6,
        us_aldkrls=t_a / (runs * num_samples) * 1e6,
        us_aldkrls_graph=_graph_us(_ald(xs, 5.0, 5e-3, 128), final_a, xs, ys),
        speedup_vs_engel=t_a / t_r,
        ald_dict_size=int(final_a.size[0]),
        ald_dict_mean=float(final_a.size.float().mean()),
        runs=runs, num_samples=num_samples,
    )
    return detail["us_rffkrls"], mse_r / mse_a, detail


def table1_highdim(runs: int = 3, num_samples: int = 4000,
                   input_dim: int = 20, *, seed: int = 0, device="cuda",
                   check_ref: bool = False):
    """The paper's §1 scaling argument: at input_dim = 20 the quantized
    dictionary grows (the curse of dimensionality) while RFF-KLMS keeps
    D = 300. derived = RFF-KLMS's speedup over QKLMS."""
    rff, gen = _setup(seed, device, input_dim, 300, 5.0)
    data = gen_kernel_expansion(gen, num_samples=num_samples,
                                input_dim=input_dim, sigma=5.0, runs=runs)
    errs_r, t_r, detail = _rff_side(
        "rffklms",
        lambda x, y, m: klms_realizations(rff, x, y, 1.0, mode=m),
        data.xs, data.ys, 400, check_ref)
    final_q, errs_q, t_q = _timed(
        lambda x, y: qklms_realizations(x, y, 5.0, 1.0, 10.0, 2048),
        data.xs, data.ys)
    detail.update(
        qklms_dict_size=int(final_q.size[0]), rff_D=300,
        us_rffklms=t_r / (runs * num_samples) * 1e6,
        us_qklms=t_q / (runs * num_samples) * 1e6,
        us_qklms_graph=_graph_us(_qklms(data.xs, 5.0, 1.0, 10.0, 2048),
                                 final_q, data.xs, data.ys),
        mse_rffklms=_tail(monte_carlo_mse(errs_r), 400),
        mse_qklms=_tail(monte_carlo_mse(errs_q), 400),
        speedup=t_q / t_r, runs=runs, num_samples=num_samples,
    )
    return detail["us_rffklms"], detail["speedup"], detail


_TABLE1 = (("example2", fig2a_klms_vs_qklms, 15000),
           ("example3", fig3a_chaotic1, 500),
           ("example4", fig3b_chaotic2, 1000))


def table1_timing(runs: int = 5, *, figures: Optional[dict] = None,
                  seed: int = 0, device="cuda"):
    """Table 1: training time a run, QKLMS vs RFF-KLMS, examples 2-4.

    ``figures`` maps ``"example2"``..``"example4"`` to the details of
    figure runs already made (so table 1 reuses them); the rest run here
    at ``runs`` runs. derived = the mean RFF-KLMS speedup (paper: 2-6x)
    in wall time. A row's ``speedup_graph`` is against QKLMS's device time
    (``us_qklms_graph``, None off the card): the wall-time speedup counts
    the host's launches of the generic loop, ``speedup_graph`` the two
    algorithms' work on the card.
    """
    rows, speeds = {}, []
    for name, fn, n in _TABLE1:
        if figures is not None and name in figures:
            r = figures[name]
        else:
            r = fn(runs=runs, num_samples=n, seed=seed, device=device)[2]
        rows[name] = {
            "rffklms_s_per_run": r["us_rffklms"] * 1e-6 * n,
            "qklms_s_per_run": r["us_qklms"] * 1e-6 * n,
            "qklms_graph_s_per_run": (None if r["us_qklms_graph"] is None
                                      else r["us_qklms_graph"] * 1e-6 * n),
            "qklms_dict": r["qklms_dict_size"],
            "speedup": r["speedup"],
            "speedup_graph": (None if r["us_qklms_graph"] is None
                              else r["us_qklms_graph"] / r["us_rffklms"]),
            "runs": r["runs"],
        }
        speeds.append(r["speedup"])
    us = rows["example2"]["rffklms_s_per_run"] / 15000 * 1e6
    return us, sum(speeds) / len(speeds), rows


def orf_vs_iid(num_seeds: int = 16, input_dim: int = 8, rff_dim: int = 64, *,
               device="cuda"):
    """Beyond the paper: orthogonal random features vs the iid draw.
    derived = RMSE(iid) / RMSE(orthogonal) at equal D (> 1: ORF wins)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(256, input_dim, generator=gen, device=dev)
    y = torch.randn(256, input_dim, generator=gen, device=dev)
    exact = gaussian_kernel(x, y, 2.0)

    def rmse(orth):
        errs = []
        for s in range(num_seeds):
            rff = sample_rff(torch.Generator().manual_seed(100 + s), input_dim,
                             rff_dim, 2.0, orthogonal=orth, device=dev)
            approx = kernel_estimate(rff, x, y)
            errs.append(float(torch.sqrt(torch.mean((approx - exact) ** 2))))
        return sum(errs) / len(errs)

    (r_iid, r_orf), sec = _seconds(lambda: (rmse(False), rmse(True)), dev)
    detail = {"rmse_iid": r_iid, "rmse_orthogonal": r_orf}
    return sec / (2 * num_seeds) * 1e6, r_iid / r_orf, detail


def krls_f32_horizon(runs: int = 32, num_samples: int = 15000,
                     window: int = 1500, *, seed: int = 0, device="cuda"):
    """How far example 2's RFF-KRLS (D = 300, lam = 1e-4, beta = 0.9995)
    stays right in f32: the same realizations through the chunk kernel
    (``mode="auto"``), the plain version in f32 and the plain version in
    float64. Returns (us a sample of the kernel run, the first tick whose
    window MSE of the kernel run exceeds twice float64's (None if none),
    detail with the MSE of each window for each run kind)."""
    rff, gen = _setup(seed, device, 5, 300, 5.0)
    xs, ys = gen_nonlinear_wiener(gen, num_samples=num_samples, runs=runs)
    rff64 = type(rff)(*(a.double() for a in rff))
    (_, kern), sec = _seconds(lambda: krls_realizations(rff, xs, ys),
                              xs.device)
    _, plain = krls_realizations(rff, xs, ys, mode="ref")
    _, exact = krls_realizations(rff64, xs.double(), ys.double(), mode="ref")

    def windows(errs):
        sq = torch.square(errs.double())
        return [float(torch.mean(sq[:, t:t + window]))
                for t in range(0, num_samples, window)]

    curves = {k: windows(e) for k, e in
              (("kernel", kern), ("plain_f32", plain), ("float64", exact))}

    def departs(name):
        for i, (got, want) in enumerate(zip(curves[name], curves["float64"])):
            if not got <= 2.0 * want:
                return i * window
        return None

    detail = {"window": window, "runs": runs, "num_samples": num_samples,
              **{f"mse_{k}": v for k, v in curves.items()},
              "departs_kernel": departs("kernel"),
              "departs_plain_f32": departs("plain_f32")}
    return sec / (runs * num_samples) * 1e6, detail["departs_kernel"], detail


def run_all(*, runs: Optional[int] = None, seed: int = 0, device="cuda",
            check_ref: bool = False) -> dict:
    """Every figure at its ``EXPERIMENTS`` settings (``runs`` caps the run
    counts; samples are never cut, but fig. 2b runs ``FIG2B_SAMPLES``, as
    ``repro``'s does), then table 1 from the figures' runs and
    ``table1_highdim``. Returns ``{name: (us, derived, detail)}``."""

    def n_runs(example):
        r = EXPERIMENTS[example].runs
        return r if runs is None else min(r, runs)

    kw = dict(seed=seed, device=device, check_ref=check_ref)
    ex = EXPERIMENTS
    jobs = {
        "fig1": lambda: fig1_convergence(
            n_runs("example1"), ex["example1"].num_samples,
            ex["example1"].rff_dim, **kw),
        "fig2a": lambda: fig2a_klms_vs_qklms(
            n_runs("example2"), ex["example2"].num_samples, **kw),
        "fig2b": lambda: fig2b_krls(n_runs("example2"), FIG2B_SAMPLES, **kw),
        "fig3a": lambda: fig3a_chaotic1(
            n_runs("example3"), ex["example3"].num_samples, **kw),
        "fig3b": lambda: fig3b_chaotic2(
            n_runs("example4"), ex["example4"].num_samples, **kw),
        "table1": lambda: table1_timing(
            figures={"example2": out["fig2a"][2], "example3": out["fig3a"][2],
                     "example4": out["fig3b"][2]}, seed=seed, device=device),
        "table1_highdim": lambda: table1_highdim(**kw),
    }
    out = {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        us, derived, detail = job()
        detail["wall_s"] = time.perf_counter() - t0
        out[name] = (us, derived, detail)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--runs", type=int, default=None,
                        help="cap every figure's run count")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--check-ref", action="store_true")
    args = parser.parse_args(argv)
    res = run_all(runs=args.runs, seed=args.seed, device=args.device,
                  check_ref=args.check_ref)
    for name, (us, derived, detail) in res.items():
        print(json.dumps({"figure": name, "us_per_sample": us,
                          "derived": derived, "detail": detail}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
