#!/usr/bin/env python3
"""Where the resident KRLS chunk kernel's time goes, the feature-tile
kernels' (the KLMS chunk and the read), the RFF attention kernels' (the
prefill's linear attention and the decode block), the replay elements'
(the KLMS element's phases, the KRLS element's launches), the feature
map's and the blocked KRLS readmit's, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``: ``python3 krls_breakdown.py``. ``python3 krls_breakdown.py --ops
SRC`` only times the replay ops (``ops.rff_features`` and
``ops.rff_krls_chunk_elements`` at the shapes below) of the ``repro_torch``
package under ``SRC`` (for example an unpacked parent commit's ``src``),
so that two trees can be compared in one call; ``--flash SRC`` likewise
times only ``ops.flash_attention`` on f32 inputs (the CUDA-core route) at
``FLASH_F32_SHAPES`` (qwen2-0.5b's prefill, deepseek's MLA head, the
launcher's reduced qwen2) for inputs from seeds 0-2.
``python3 krls_breakdown.py --compact`` times the compact KRLS route
(``csrc/krls_compact.cu``) by phase at (B, T, d, D) = (1024, 16 and 1, 5,
400 and 1024), through variants that stop the call after a phase, beside
the streaming route's C entry, then runs the Tc study (``tc_study``: the
compact form's plain version in f32 for Tc = 16 to 128 against a float64
tick run at lam = 1e-4, beside the tick form's own f32 distance).
``python3 krls_breakdown.py --route-crossover`` times kernel 4's two
hand-written routes where both take the shape (P's triangle fits a block:
D <= 335 at d = 5), each forced through the wrapper in turns (resident,
compact, compact, resident) over ``CROSSOVER_BANKS`` x ``CROSSOVER_TICKS``
at each of ``CROSSOVER_WIDTHS``, every tick live from P = I / lam, and at T
= 1 the step wrapper too, beside the route ``krls_chunk_route`` picks: the
table behind that rule (``chunking.krls_compact_pays``).
``python3 krls_breakdown.py --flash-variants`` times the f32 flash kernel
(``csrc/flash_attention.cu``) through its C entry at every thread tile
it takes at those shapes and llama3-8b's head, then its
``FLASH_VARIANTS`` (without ``expf``, without Q K^T, without P V, other
unrolls) at the tile ``flash_plan`` picks, and the same call through the
wrapper and the op (the host's share).

``python3 krls_breakdown.py --predict-few`` times the read kernel's
few-row route (``csrc/bank_predict.cu`` ``bank_predict_few``) by part
through its C entry (the packing, the z tiles, the reduce: variants that
launch one part, the last two on the workspace a full call leaves) beside
the bank route's entry, the wrapper, the op and the plain version, in
turns, with the device time a call (torch.profiler), at one tenant (1, 64,
128 -> 2048),
the KRLS read's width (1, 64, 5, 300) and the sharded KRLS predict's
partial (1, 64, 5, 8192), f32 and bf16; then both routes' entries at B =
1 .. 512 tenants of 64 queries (the route rule's threshold study); then
kernel 1 (``klms_bank_chunk``) at diffusion's B = 1 shapes (``KLMS_B1``).
``python3 krls_breakdown.py --policy SRC`` serves phase 18's KLMS policy
stream (``chip_smoke.phase_policy``'s kernel servers alone, each policy)
with the ``repro_torch`` under ``SRC`` and prints each policy's read and
write µs p50/p99, for a parent tree in the same call.

It compiles timing-only variants of ``src/repro_torch/csrc/krls_bank.cu``
into ``build/repro_torch/breakdown/``, each with one part of the resident
tick removed or changed (so their results are wrong and are not checked),
and times ``krls_bank_chunk_resident`` at the KRLS serving shape (B = 1024,
T = 16, d = 5, D = 300, P = I / lam, no mask) and at T = 1 with
``chip_smoke.time_ms``, the full kernel first and last. The full kernel's
time less a variant's is that part's share. A variant whose text no longer
matches the source stops the run. It then does the same for variants of
``csrc/klms_bank.cu`` (``klms_bank_chunk`` at the KLMS serving shape, B =
1024, T = 16, d = 128, D = 2048) and ``csrc/bank_predict.cu``
(``bank_predict`` at the read shape, Q = 64, f32 and bf16), called through
their C entries with workspaces of the wrappers' sizes. Last it times
the KLMS replay element (``csrc/rff_scan.cu``) at the replay shape (T =
256 ticks, one chunk, d = 128, D = 2048, mu = 0.5) by phase, through the
C entries: the features (``rff_features``), then ``klms_chunk_elements``
of variants of ``csrc/rff_scan.cu`` that launch one phase each (Gram;
solve; T Z and v; the product) on the workspace a full run leaves, the
four at once (the source as it is), and the whole call through
``ops.rff_klms_chunk_elements``. Then the KRLS replay element at the
paper's replay shape (T = 256, d = 5, D = 300, beta = 0.9995) and at D =
2048 (d = 128, beta = 0.99), through its C entry: the whole call, the
prep launch alone (weights, g, Zp and [w Zp | c]), the product alone (on
the workspace a full run leaves), the whole call on each product tile
(64, 32), with the device time of the whole entry (torch.profiler);
the features of its rows and the op. Then the feature map
(``csrc/rff_features.cu``) through its C entry at 256 and 65536 rows (d =
128, D = 2048), f32 and bf16, with the device time at 256 rows, and at
65536 rows f32 its ``FEATURE_VARIANTS`` (without ``cosf``, without the z
stores, the packing alone). Last the blocked KRLS readmit of
a 256-tick log at the paper's settings by part: the features, the element
op (features included) and the ``torch.linalg`` tail (compose, apply to
lam I, invert, solve), against the whole ``replay_krls``. It prints the
card's name and power limit and one JSON line for each.

Variants:
  no_downdate  the downdate of the ticks after the first live one skipped;
  no_pz_reads  pz's triangle reads (and their addressing) skipped, the
               multiply-add chain kept;
  no_divides   the downdate's divides made multiplies;
  unroll_2, unroll_4  the downdate loops unrolled by 2 or 4;
  threads_512, threads_768  a block of 512 or 768 threads (16, 24 warps).

Feature-tile variants:
  klms no_ticks    the tick loop (one warp a tenant) not launched: packing
                   and the feature tile alone;
  klms no_cos      the feature tile's epilogue without ``cosf``;
  read no_cos      the read's epilogue without ``cosf`` (both routes);
  read no_epilogue the epilogue's bias, ``cosf``, scale and theta dropped
                   (z is the product itself): packing and the products.

Attention variants (``csrc/rff_attention.cu`` through its C entries, at
chip_smoke's LM shapes: linear attention at (BH, S, D, dv) = (56, 2048,
256, 64), normalized; the decode block at (56, 64, 256, 64), prf, f32,
T = 1 by torch.profiler device time over DECODE_CALLS launches and
T = 512 by CUDA events):
  linear state_only / outputs_only  one of the two launches alone (the
                   state's walk over chunks, which writes each chunk's
                   S_prev and z_prev; the outputs, on the workspace the
                   full call leaves);
  linear state_only_no_store  the walk without its S_prev stores: the
                   local states' arithmetic (the stores are the prefix's
                   cost);
  decode no_s_pass     the S update and phi_q S skipped: loads, featurize,
                   reductions and barriers;
  decode no_featurize  featurize skipped (the feature rows keep what they
                   hold): loads, the S pass, reductions and barriers.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (BANK, CHUNK, D_FEAT, D_IN, DECODE_CALLS,
                        DECODE_SHAPES, K_BETA, K_D_FEAT, K_D_IN, K_LAM,
                        LINEAR_SHAPES, LOG_CAP, MU, Q, SIGMA, SRC,
                        decode_inputs, device_busy, f32_tensor,
                        feature_inputs, inputs, krls_inputs, positive,
                        time_ms)

DIVIDES = [(f"__fdiv_rn(__fsub_rn(p, __fmul_rn({u}, {v})), beta)",
            f"__fmul_rn(__fsub_rn(p, __fmul_rn({u}, {v})), beta)", 1)
           for u, v in (("ga.x", "gj.y"), ("gj.x", "ga.y"),
                        ("gb.x", "gj.y"), ("gj.x", "gb.y"))]
UNROLL = "#pragma unroll {}\n        for (; c <"
VARIANTS = {  # name: [(text, replacement, times the text occurs)]
    "full": [],
    "no_downdate": [("for (int r = warp; r < (D + 1) / 2; r += kResWarps) {",
                     "for (int r = warp; r < 0; r += kResWarps) {", 1)],
    "no_pz_reads": [(
        "acc = __fmaf_rn(t.tri[j < i ? jb[m] + i : base + j], zr[m], acc);",
        "acc = __fmaf_rn(1.f, zr[m], acc);", 1)],
    "no_divides": DIVIDES,
    "unroll_2": [(UNROLL.format(1), UNROLL.format(2), 2)],
    "unroll_4": [(UNROLL.format(1), UNROLL.format(4), 2)],
    "threads_512": [("constexpr int kResThreads = 1024;",
                     "constexpr int kResThreads = 512;", 1)],
    "threads_768": [("constexpr int kResThreads = 1024;",
                     "constexpr int kResThreads = 768;", 1)],
}


def build_all(build, csrc, out) -> dict:
    """Every variant's ``krls_bank_chunk_resident``, compiled in parallel."""
    out.mkdir(parents=True, exist_ok=True)
    source = (csrc / "krls_bank.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = source
        for old, new, count in edits:
            if src.count(old) != count:
                raise SystemExit(f"{name}: krls_bank.cu no longer holds "
                                 f"{old!r} {count} time(s)")
            src = src.replace(old, new)
        (out / f"krls_{name}.cu").write_text(src)
        lib = out / f"libkrls_{name}.so"
        procs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / f"krls_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).krls_bank_chunk_resident
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fns[name] = fn
    return fns


KLMS_COS = ("v[c] = __fmul_rn(sj[j], cosf(__fadd_rn(acc[i][j], bj[j])));",
            "v[c] = __fmul_rn(sj[j], __fadd_rn(acc[i][j], bj[j]));", 1)
READ_COS = [
    ("const float z = __fmul_rn(sj, cosf(__fadd_rn(acc[i][j], bj)));",
     "const float z = __fmul_rn(sj, __fadd_rn(acc[i][j], bj));", 1),
    ("__fmul_rn(sj, cosf(__fadd_rn(acc[mi][ni][2 * h + c], bj))));",
     "__fmul_rn(sj, __fadd_rn(acc[mi][ni][2 * h + c], bj)));", 1)]
READ_EPILOGUE = [
    ("const float z = __fmul_rn(sj, cosf(__fadd_rn(acc[i][j], bj)));",
     "const float z = acc[i][j];", 1),
    ("part[i] = __fmaf_rn(__ldg(theta + toff[i] + col0 + cc), z, part[i]);",
     "part[i] = __fadd_rn(z, part[i]);", 1),
    ("const float z = round_bf16(\n                __fmul_rn(sj, cosf("
     "__fadd_rn(acc[mi][ni][2 * h + c], bj))));",
     "const float z = acc[mi][ni][2 * h + c];", 1),
    ("part[mi][h] = __fmaf_rn(__ldg(theta + toff[mi][h] + col0 + cc), z,\n"
     "                                    part[mi][h]);",
     "part[mi][h] = __fadd_rn(z, part[mi][h]);", 1)]
TILE_VARIANTS = {  # name: (source, [(text, replacement, times)])
    "klms_full": ("klms_bank", []),
    "klms_no_ticks": ("klms_bank", [(
        "    rc = ticks(t0 == 0 ? theta : theta_out, z, ys, mask, mu, "
        "theta_out, pred,\n               err, B, Slab{t0, ts, T}, D, "
        "reg_cols, st);", "    rc = cudaSuccess;", 1)]),
    "klms_no_cos": ("klms_bank", [KLMS_COS]),
    "read_full": ("bank_predict", []),
    "read_no_cos": ("bank_predict", READ_COS),
    "read_no_epilogue": ("bank_predict", READ_EPILOGUE),
}


def build_tiles(build, csrc, out, variants=None) -> dict:
    """Every variant's library (``TILE_VARIANTS`` unless given), compiled
    in parallel (the header is copied beside the variants)."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "feature_tile.cuh").write_text((csrc / "feature_tile.cuh").read_text())
    procs = {}
    for name, (source, edits) in (variants or TILE_VARIANTS).items():
        src = (csrc / f"{source}.cu").read_text()
        for old, new, count in edits:
            if src.count(old) != count:
                raise SystemExit(f"{name}: {source}.cu no longer holds "
                                 f"{old!r} {count} time(s)")
            src = src.replace(old, new)
        (out / f"{name}.cu").write_text(src)
        lib = out / f"lib{name}.so"
        procs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def tile_breakdown(build, dev) -> dict:
    """The feature-tile variants at the serving shapes, each timed twice
    (the full kernels first and last)."""
    from repro_torch.kernels.chunking import (feature_tile_pack_floats,
                                              predict_workspace_bytes)
    from repro_torch.kernels.rff_klms_step import klms_slab_ticks

    libs = build_tiles(build, build.CSRC, build.BUILD_DIR / "breakdown")
    rng = np.random.default_rng(0)
    a = inputs(rng, BANK, CHUNK, D_IN, D_FEAT, dev)
    xq = torch.from_numpy(
        rng.normal(size=(BANK, Q, D_IN)).astype(np.float32)).to(dev)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    slab = klms_slab_ticks(BANK, CHUNK, D_FEAT)
    z = torch.empty(BANK * slab * D_FEAT, device=dev)
    pk = torch.empty(feature_tile_pack_floats(BANK * slab, D_IN, D_FEAT),
                     device=dev)
    theta_out = torch.empty_like(a["theta"])
    pred, err = torch.empty_like(a["ys"]), torch.empty_like(a["ys"])
    out = torch.empty(BANK, Q, device=dev)
    ws = torch.empty(max(predict_workspace_bytes(BANK * Q, D_IN, D_FEAT, bf)
                         for bf in (False, True)),
                     dtype=torch.uint8, device=dev)

    def call(name, route):
        lib = libs[name]
        if route == "chunk":
            fn = lib.klms_bank_chunk
            fn.argtypes = [P] * 10 + [L] + [P] * 3 + [I] * 6 + [P]
            args = (*(a[k].data_ptr() for k in ("theta", "xs", "ys", "mask",
                                                 "mu", "w", "b", "s")),
                    z.data_ptr(), pk.data_ptr(), pk.numel(),
                    theta_out.data_ptr(), pred.data_ptr(), err.data_ptr(),
                    BANK, CHUNK, D_IN, D_FEAT, 64, slab, stream)
        else:
            fn = lib.bank_predict
            fn.argtypes = [P] * 7 + [L] + [I] * 5 + [P]
            args = (a["theta"].data_ptr(), xq.data_ptr(),
                    *(a[k].data_ptr() for k in ("w", "b", "s")),
                    out.data_ptr(), ws.data_ptr(), ws.numel(), BANK, Q, D_IN,
                    D_FEAT, int(route == "bf16"), stream)
        if fn(*args):
            raise SystemExit(f"{name} {route}: launch failed")

    cases = [(name, route) for name in TILE_VARIANTS
             for route in (("chunk",) if name.startswith("klms")
                           else ("f32", "bf16"))]
    ms = {f"{n}/{r}": [] for n, r in cases}
    for name, route in [*cases, *[c for c in cases if "full" in c[0]]]:
        ms[f"{name}/{route}"].append(time_ms(lambda: call(name, route), 10))
    return {"shape": {"B": BANK, "T": CHUNK, "Q": Q, "d": D_IN, "D": D_FEAT},
            "ms": ms}


LINEAR_LAUNCHES = {
    "state": "  if ((err = linear_state(k, v, ws, BH, S, D, dv, st)) != "
             "cudaSuccess) return err;\n",
    "outputs": "  if ((err = linear_outputs(q, k, v, ws, out, BH, S, D, dv, "
               "normalize != 0, eps, st)) != cudaSuccess) return err;\n",
}
ATTENTION_VARIANTS = {  # name: [(text, replacement, times)]
    "full": [],
    **{f"{keep}_only": [(line, "", 1) for name, line in LINEAR_LAUNCHES.items()
                        if name != keep] for keep in LINEAR_LAUNCHES},
    "state_only_no_store": [(LINEAR_LAUNCHES["outputs"], "", 1), (
        "      if (d < g.Dp)\n", "      if (d < g.Dp && acc[i][0] == 12345.f)\n",
        1)],
    "no_s_pass": [("    s_pass(St, pq, pk, vb + cur * kDecCols, red, D, part, "
                   "quad, lane, warp);\n", "", 1)],
    "no_featurize": [(
        "    float den_part = featurize<PRF, BF16>(wsrc, xq, xq + dh, bias, "
        "scale, nrm[2 * cur], nrm[2 * cur + 1], z, pq, pk, dh, D, root_d);",
        "    float den_part = 0.f;", 1)],
}


def attention_breakdown(build, dev) -> dict:
    """The attention variants, each timed twice (the full kernels first and
    last): linear attention's phases and the decode block's parts."""
    from repro_torch.kernels.chunking import linear_attention_plan
    from repro_torch.kernels.ref import prf_root

    libs = build_tiles(build, build.CSRC, build.BUILD_DIR / "breakdown",
                       {f"attn_{name}": ("rff_attention", edits)
                        for name, edits in ATTENTION_VARIANTS.items()})
    rng = np.random.default_rng(0)
    P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bh, slen, dfeat, dv, _ = LINEAR_SHAPES[0]
    q, k = (positive(rng, bh, slen, dfeat, device=dev) for _ in range(2))
    v = f32_tensor(rng, bh, slen, dv, device=dev)
    out = torch.empty_like(v)
    nbytes = linear_attention_plan(bh, slen, dfeat, dv).workspace_bytes
    ws = torch.empty(nbytes // 4, device=dev)
    dbh, dh, ddf, ddv = DECODE_SHAPES[0]
    root = float(prf_root(ddf))
    dec = {t: decode_inputs(rng, dbh, t, dh, ddf, ddv, "prf", dev)
           for t in (1, 512)}
    dec_out = {t: (torch.empty(dbh, t, ddv, device=dev),
                   torch.empty_like(dec[t][0]), torch.empty_like(dec[t][1]))
               for t in dec}

    def linear(name):
        fn = libs[f"attn_{name}"].rff_linear_attention
        fn.argtypes = [P] * 5 + [L] + [I] * 5 + [F, P]
        if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ws.data_ptr(), nbytes, bh, slen, dfeat, dv, 1, 1e-6, stream):
            raise SystemExit(f"linear {name}: launch failed")

    def decode(name, tlen):
        fn = libs[f"attn_{name}"].rff_decode_block
        fn.argtypes = [P] * 11 + [I] * 8 + [F, F, P]
        o, s_new, z_new = dec_out[tlen]
        if fn(*(t.data_ptr() for t in dec[tlen]), o.data_ptr(),
              s_new.data_ptr(), z_new.data_ptr(), dbh, tlen, dh, ddf, ddv, 1,
              0, 1, 1e-6, root, stream):
            raise SystemExit(f"decode {name}: launch failed")

    lin_names = ["full", "state_only", "state_only_no_store", "outputs_only",
                 "full"]
    dec_names = ["full", "no_s_pass", "no_featurize", "full"]
    ms = {f"linear/{n}": [] for n in lin_names}
    ms.update({f"decode_T1_device/{n}": [] for n in dec_names})
    ms.update({f"decode_T512/{n}": [] for n in dec_names})
    for name in lin_names:
        ms[f"linear/{name}"].append(time_ms(lambda: linear(name), 10))
    for name in dec_names:
        prof = device_busy(lambda: [decode(name, 1)
                                    for _ in range(DECODE_CALLS)])
        ms[f"decode_T1_device/{name}"].append(prof["device_ms"] / DECODE_CALLS)
        ms[f"decode_T512/{name}"].append(time_ms(lambda: decode(name, 512), 5))
    return {"linear_shape": LINEAR_SHAPES[0][:4],
            "decode_shape": DECODE_SHAPES[0], "ms": ms}


ELEMENT_LAUNCHES = {"gram": ("gram_kernel",),
                    "solve": ("diag_kernel", "off_kernel"),
                    "tz_and_v": ("tz_kernel",), "product": ("gemm_kernel",)}
# name: (source, [(text, replacement, times)]): each phase's variant skips
# the other phases' launches; all_four is the source as it is.
ELEMENT_VARIANTS = {
    f"element_{name}": ("rff_scan", [
        (f"    {k}<<<", f"    if (0) {k}<<<", 1)
        for other, ks in ELEMENT_LAUNCHES.items() if other != name
        for k in ks])
    for name in ELEMENT_LAUNCHES}
ELEMENT_VARIANTS["element_all_four"] = ("rff_scan", [])


def element_breakdown(dev) -> dict:
    """The KLMS replay element's phases at the replay shape, each timed
    twice (the whole call first and last)."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.chunking import feature_tile_pack_floats
    from repro_torch.kernels.rff_features import _lib as features_lib
    from repro_torch.kernels.rff_scan import _SIGNATURES
    from repro_torch.kernels.rff_scan import _lib as scan_lib

    rng = np.random.default_rng(0)
    a = feature_inputs(rng, LOG_CAP, D_IN, D_FEAT, dev)
    ys = f32_tensor(rng, LOG_CAP, device=dev)
    z = torch.empty(LOG_CAP, D_FEAT, device=dev)
    out_a = torch.empty(1, D_FEAT, D_FEAT, device=dev)
    out_v = torch.empty(1, D_FEAT, device=dev)
    flib, slib = features_lib(), scan_lib()
    ws = torch.empty(slib.klms_element_chunk_floats(LOG_CAP, D_FEAT),
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    fws = torch.empty(feature_tile_pack_floats(LOG_CAP, D_IN, D_FEAT),
                      device=dev)

    def features():
        features_call(flib, a, z, fws, 0, stream)

    libs = build_tiles(_build, _build.CSRC, _build.BUILD_DIR / "breakdown",
                       ELEMENT_VARIANTS)
    for lib in libs.values():
        lib.klms_chunk_elements.argtypes = _SIGNATURES["klms_chunk_elements"]

    def phases(name):
        if libs[f"element_{name}"].klms_chunk_elements(
                z.data_ptr(), ys.data_ptr(), None, out_a.data_ptr(),
                out_v.data_ptr(), ws.data_ptr(), ws.numel(), 1, LOG_CAP,
                D_FEAT, MU, 0, 1e-6, stream):
            raise SystemExit(f"klms_chunk_elements {name}: failed")

    def whole():
        ops.rff_klms_chunk_elements(a["x"], ys, a["w"], a["b"], MU, a["s"],
                                    mode="cuda")

    features()
    phases("all_four")
    ms = {"ops": [time_ms(whole, 10)], "features": [time_ms(features, 10)]}
    for name in [*ELEMENT_LAUNCHES, "all_four"]:
        ms[name] = [time_ms(lambda: phases(name), 10) for _ in range(2)]
    ms["ops"].append(time_ms(whole, 10))
    return {"shape": {"T": LOG_CAP, "Tc": LOG_CAP, "d": D_IN, "D": D_FEAT,
                      "mu": MU}, "ms": ms}


def features_call(flib, a, out, ws, bf16, stream) -> None:
    """``rff_features`` through its C entry (the plan's tile), a (x, w, b,
    s) into out."""
    m, d = a["x"].shape
    if flib.rff_features(*(t.data_ptr() for t in (a["x"], a["w"], a["b"],
                                                   a["s"], out, ws)),
                         ws.numel(), m, d, a["w"].shape[1], bf16, 0, stream):
        raise SystemExit("rff_features: launch failed")


# The KRLS element's launches (csrc/rff_scan.cu krls_run): prep, then the
# product (r's tiles in front).
KRLS_PRODUCT = ("    const int t = krls_tile(tile, D, ng);\n",
                "    const int t = krls_tile(tile, D, ng);\n    if (t) continue;\n",
                1)
KRLS_NO_PREP = ("    krls_prep_kernel<<<", "    if (0) krls_prep_kernel<<<", 1)
KRLS_ELEMENT_VARIANTS = {
    "kelem_full": ("rff_scan", []),
    "kelem_prep_only": ("rff_scan", [KRLS_PRODUCT]),
    "kelem_product_only": ("rff_scan", [KRLS_NO_PREP]),
}
KRLS_SHAPES = {"paper": (K_D_IN, K_D_FEAT, K_BETA),
               "d2048": (D_IN, D_FEAT, 0.99)}


def krls_element_breakdown(dev) -> dict:
    """The KRLS replay element's launches at both shapes through its C
    entry, each timed twice (the whole op first and last), and the device
    time of the whole entry."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.chunking import feature_tile_pack_floats
    from repro_torch.kernels.rff_features import _lib as features_lib
    from repro_torch.kernels.rff_scan import _SIGNATURES
    from repro_torch.kernels.rff_scan import _lib as scan_lib

    libs = build_tiles(_build, _build.CSRC, _build.BUILD_DIR / "breakdown",
                       KRLS_ELEMENT_VARIANTS)
    for lib in libs.values():
        lib.krls_chunk_elements.argtypes = _SIGNATURES["krls_chunk_elements"]
    flib, slib = features_lib(), scan_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    out = {}
    for label, (d, dfeat, beta) in KRLS_SHAPES.items():
        a = feature_inputs(rng, LOG_CAP, d, dfeat, dev)
        ys = f32_tensor(rng, LOG_CAP, device=dev)
        z = torch.empty(LOG_CAP, dfeat, device=dev)
        fws = torch.empty(feature_tile_pack_floats(LOG_CAP, d, dfeat),
                          device=dev)
        g = torch.empty(1, device=dev)
        phi = torch.empty(1, dfeat, dfeat, device=dev)
        r = torch.empty(1, dfeat, device=dev)
        ws = torch.empty(slib.krls_element_chunk_floats(LOG_CAP, dfeat),
                         device=dev)

        def part(name, tile=0):
            if libs[name].krls_chunk_elements(
                    z.data_ptr(), ys.data_ptr(), None, beta, g.data_ptr(),
                    phi.data_ptr(), r.data_ptr(), ws.data_ptr(), ws.numel(),
                    1, LOG_CAP, dfeat, tile, stream):
                raise SystemExit(f"krls_chunk_elements {name}: failed")

        def whole():
            ops.rff_krls_chunk_elements(a["x"], ys, a["w"], a["b"], beta,
                                        a["s"], mode="cuda")

        features_call(flib, a, z, fws, 0, stream)
        part("kelem_full")
        ms = {"ops": [time_ms(whole, 10)],
              "features": [time_ms(lambda: features_call(flib, a, z, fws, 0,
                                                         stream), 10)]}
        for name in KRLS_ELEMENT_VARIANTS:
            ms[name] = [time_ms(lambda: part(name), 10) for _ in range(2)]
        for tile in (64, 32):
            ms[f"kelem_full tile={tile}"] = [
                time_ms(lambda: part("kelem_full", tile), 10)
                for _ in range(2)]
        ms["ops"].append(time_ms(whole, 10))
        calls = 20
        busy = device_busy(lambda: [part("kelem_full") for _ in range(calls)],
                           named="krls")
        out[label] = {"shape": {"T": LOG_CAP, "d": d, "D": dfeat,
                                "beta": beta},
                      "ms": ms, "entry_device_ms": busy["device_ms"] / calls,
                      "entry_kernels": busy["named"]}
        del a, z, phi, ws
    return out


FEATURE_STORE = ("            *reinterpret_cast<float4*>(zr + col) =\n",
                 "            if (v[0] + v[1] + v[2] + v[3] == 12345.f)\n"
                 "            *reinterpret_cast<float4*>(zr + col) =\n", 1)
# name: (source, [(text, replacement, times)]), timed at 65536 rows, f32.
FEATURE_VARIANTS = {
    "feat_full": ("rff_features", []),
    "feat_no_cos": ("rff_features", [(
        "v[c] = __fmul_rn(sj[j], cosf(__fadd_rn(acc[i][j], bj[j])));",
        "v[c] = __fmul_rn(sj[j], __fadd_rn(acc[i][j], bj[j]));", 1)]),
    "feat_no_store": ("rff_features", [FEATURE_STORE]),
    "feat_pack_only": ("rff_features", [(
        "  if (rows == 128)\n    return bf16 ?",
        "  return cudaSuccess;\n  if (rows == 128)\n    return bf16 ?", 1)]),
}


def features_breakdown(dev) -> dict:
    """The feature map through its C entry at 256 and 65536 rows, f32 and
    bf16, by CUDA events (twice each), and by device time at 256 rows;
    then at 65536 rows, f32, the timing-only variants (``FEATURE_VARIANTS``:
    without ``cosf``, without the z stores, the packing alone), the full
    source first and last."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunking import feature_tile_pack_floats
    from repro_torch.kernels.rff_features import _SIGNATURES
    from repro_torch.kernels.rff_features import _lib as features_lib

    flib = features_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    out = {}
    for m in (LOG_CAP, BANK * Q):
        a = feature_inputs(rng, m, D_IN, D_FEAT, dev)
        ws = torch.empty(feature_tile_pack_floats(m, D_IN, D_FEAT),
                         device=dev)
        for bf16, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            z = torch.empty(m, D_FEAT, dtype=dtype, device=dev)
            run = lambda: features_call(flib, a, z, ws, bf16, stream)
            rec = {"ms": [time_ms(run, 10) for _ in range(2)]}
            if m == LOG_CAP:
                calls = 20
                busy = device_busy(lambda: [run() for _ in range(calls)],
                                   named="_kernel")
                rec["device_ms"] = busy["device_ms"] / calls
                rec["kernels"] = busy["named"]
            out[f"{m}x{D_IN}->{D_FEAT} {'bf16' if bf16 else 'f32'}"] = rec
            if m == BANK * Q and not bf16:
                libs = build_tiles(_build, _build.CSRC,
                                   _build.BUILD_DIR / "breakdown",
                                   FEATURE_VARIANTS)
                for lib in libs.values():
                    lib.rff_features.argtypes = _SIGNATURES["rff_features"]
                rec["variants"] = {name: [] for name in FEATURE_VARIANTS}
                for name in [*FEATURE_VARIANTS, "feat_full"]:
                    rec["variants"][name].append(time_ms(
                        lambda: features_call(libs[name], a, z, ws, 0,
                                              stream), 10))
            del z
        del a, ws
    return out


def readmit_breakdown(dev) -> dict:
    """The blocked KRLS readmit of a 256-tick log at the paper's settings,
    by part, each timed twice (CUDA events; host time included)."""
    from repro_torch.core.scan import (DecayElement, _decay_to_rls,
                                       decay_apply, decay_combine,
                                       replay_krls, tree_reduce)
    from repro_torch.features import rff_map
    from repro_torch.features.base import as_trig_or_none
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    fm = rff_map(torch.Generator().manual_seed(7), K_D_IN, K_D_FEAT, SIGMA,
                 device=dev)
    tf = as_trig_or_none(fm)
    xs = f32_tensor(rng, LOG_CAP, K_D_IN, device=dev)
    ys = f32_tensor(rng, LOG_CAP, device=dev)
    elements = DecayElement(*ops.rff_krls_chunk_elements(
        xs, ys, tf.omega, tf.bias, K_BETA, tf.scale))
    step = torch.tensor(LOG_CAP, dtype=torch.int32, device=dev)

    def tail():
        composed = tree_reduce(decay_combine, elements)
        phi0 = K_LAM * torch.eye(K_D_FEAT, device=dev)
        phi, r = decay_apply(composed, phi0,
                             torch.zeros(K_D_FEAT, device=dev))
        _decay_to_rls(phi, r, step)

    parts = {
        "readmit_blocked": lambda: replay_krls(fm, xs, ys, K_LAM, K_BETA,
                                               mode="blocked"),
        "features": lambda: ops.rff_features(xs, tf.omega, tf.bias,
                                             tf.scale),
        "element_op": lambda: ops.rff_krls_chunk_elements(
            xs, ys, tf.omega, tf.bias, K_BETA, tf.scale),
        "linalg_tail": tail,
    }
    ms = {name: [time_ms(fn, 10) for _ in range(2)]
          for name, fn in parts.items()}
    return {"shape": {"T": LOG_CAP, "d": K_D_IN, "D": K_D_FEAT,
                      "lam": K_LAM, "beta": K_BETA}, "ms": ms}


# The few-row read route by part: variants of csrc/bank_predict.cu whose
# other launches are prefixed ``if (0)``.
_FEW_PACK = [("  cudaError_t rc = ft::pack(",
              "  cudaError_t rc = cudaSuccess;\n  if (0) rc = ft::pack(", 1),
             ("  pack_bf16_kernel<<<", "  if (0) pack_bf16_kernel<<<", 1)]
_FEW_Z = [("  if (rc == cudaSuccess) rc = few_z_f32(",
           "  if (0) rc = few_z_f32(", 1),
          ("  if (rc == cudaSuccess)\n    rc = few_z_bf16(",
           "  if (0)\n    rc = few_z_bf16(", 1)]
_FEW_REDUCE = [("  if (rc == cudaSuccess) rc = few_reduce(",
                "  if (0) rc = few_reduce(", 2)]
FEW_VARIANTS = {
    "few_full": ("bank_predict", []),
    "few_pack": ("bank_predict", _FEW_Z + _FEW_REDUCE),
    "few_z": ("bank_predict", _FEW_PACK + _FEW_REDUCE),
    "few_reduce": ("bank_predict", _FEW_PACK + _FEW_Z),
}
# (B, Q, d, D): one tenant at the KLMS serving widths, at the KRLS read's,
# and the sharded KRLS predict's partial (D = 32768 on four ranks).
FEW_PARTS_SHAPES = [(1, Q, D_IN, D_FEAT), (1, Q, K_D_IN, K_D_FEAT),
                    (1, Q, K_D_IN, 8192)]
FEW_STUDY_BANKS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 384, 512)
FEW_STUDY_WIDTHS = ((D_IN, D_FEAT), (K_D_IN, K_D_FEAT))  # (d, D)
# Kernel 1 at phase 20's diffusion nodes (B = 1): the reference run's
# (T, d, D) = (1, 5, 100), a combine every tick, and example 1's (50, 5,
# 1000), a combine every 50 ticks.
KLMS_B1 = ((1, 5, 100), (50, 5, 1000))
PROFILED_CALLS = 20


def predict_few_breakdown(build, dev) -> dict:
    """The few-row route by part through the C entry, beside the bank
    route's entry, the wrapper, the op and the plain version (in turns:
    each case forward, then backward), with the C entries' device time a
    call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import predict_workspace_bytes
    from repro_torch.kernels.rff_predict import rff_bank_predict_cuda

    libs = build_tiles(build, build.CSRC, build.BUILD_DIR / "breakdown_few",
                       FEW_VARIANTS)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for lib in libs.values():
        for entry in ("bank_predict", "bank_predict_few"):
            getattr(lib, entry).argtypes = [P] * 7 + [L] + [I] * 5 + [P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    out = {}
    for bank, qlen, d, dfeat in FEW_PARTS_SHAPES:
        a = inputs(rng, bank, qlen, d, dfeat, dev)
        res = torch.empty(bank, qlen, device=dev)
        for prec in (None, "bf16"):
            bf = int(prec == "bf16")
            ws = torch.empty(predict_workspace_bytes(bank * qlen, d, dfeat,
                                                     bool(bf), "few"),
                             dtype=torch.uint8, device=dev)

            def entry(name, fn_name):
                def run():
                    code = getattr(libs[name], fn_name)(
                        a["theta"].data_ptr(), a["xs"].data_ptr(),
                        a["w"].data_ptr(), a["b"].data_ptr(),
                        a["s"].data_ptr(), res.data_ptr(), ws.data_ptr(),
                        ws.numel(), bank, qlen, d, dfeat, bf, stream)
                    if code:
                        raise SystemExit(f"{name} {fn_name}: cudaError {code}")
                return run

            cases = {name: entry(name, "bank_predict_few")
                     for name in FEW_VARIANTS}
            cases["bank_entry"] = entry("few_full", "bank_predict")
            cases["wrapper"] = lambda: rff_bank_predict_cuda(
                a["theta"], a["xs"], a["w"], a["b"], a["s"], precision=prec)
            cases["op"] = lambda: ops.rff_bank_predict(
                a["theta"], a["xs"], a["w"], a["b"], a["s"], mode="cuda",
                precision=prec)
            cases["plain"] = lambda: ops.rff_bank_predict(
                a["theta"], a["xs"], a["w"], a["b"], a["s"], mode="ref",
                precision=prec)
            ms = {name: [] for name in cases}
            for name in [*cases, *reversed(cases)]:
                ms[name].append(time_ms(cases[name], 20))
            device = {}
            for name in ("few_full", "few_pack", "few_z", "few_reduce",
                         "bank_entry"):
                prof = device_busy(
                    lambda: [cases[name]() for _ in range(PROFILED_CALLS)],
                    named="few")
                device[name] = {
                    "ms": prof["device_ms"] / PROFILED_CALLS,
                    "launches": prof["kernel_launches"] / PROFILED_CALLS}
            out[f"{bank}x{qlen}x{d}->{dfeat} {prec or 'f32'}"] = {
                "ms": ms, "device_ms_a_call": device}
    return out


def predict_route_study(dev) -> dict:
    """Both routes' C entries at B = 1 .. 512 tenants of Q queries at the
    KLMS and KRLS serving widths, f32 and bf16, in turns (bank, few, few,
    bank)."""
    from repro_torch.kernels import rff_predict
    from repro_torch.kernels.chunking import (predict_route,
                                              predict_workspace_bytes)

    lib = rff_predict._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(1)
    out = {}
    for d, dfeat in FEW_STUDY_WIDTHS:
        a = inputs(rng, max(FEW_STUDY_BANKS), Q, d, dfeat, dev)
        for bank in FEW_STUDY_BANKS:
            res = torch.empty(bank, Q, device=dev)
            for prec in ("f32", "bf16"):
                bf = int(prec == "bf16")
                ws = torch.empty(predict_workspace_bytes(bank * Q, d, dfeat,
                                                         bool(bf), "few"),
                                 dtype=torch.uint8, device=dev)

                def run(route):
                    fn = (lib.bank_predict_few if route == "few"
                          else lib.bank_predict)
                    code = fn(a["theta"].data_ptr(), a["xs"].data_ptr(),
                              a["w"].data_ptr(), a["b"].data_ptr(),
                              a["s"].data_ptr(), res.data_ptr(),
                              ws.data_ptr(), ws.numel(), bank, Q, d, dfeat,
                              bf, stream)
                    if code:
                        raise SystemExit(f"{route} at B = {bank}: "
                                         f"cudaError {code}")

                ms = {"bank": [], "few": []}
                for route in ("bank", "few", "few", "bank"):
                    ms[route].append(time_ms(lambda: run(route), 10))
                out[f"d{d} D{dfeat} B{bank} {prec}"] = {
                    "ms": ms, "rule": predict_route(bank * Q, dfeat),
                    "bank_blocks": -(-bank * Q // 128)}
            del res, ws
        del a
    return out


def klms_b1_times(dev) -> dict:
    """Kernel 1 through the op at diffusion's B = 1 shapes, its plain
    version in turns, the device time a call and the bound (chip_smoke's
    count for kernel 1: W, b, s, theta in and out, each tick's x, y, mask
    and outputs, mu; 2 d D + 7 D operations a tick)."""
    from chip_smoke import bound_ms
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    out = {}
    for tlen, d, dfeat in KLMS_B1:
        a = inputs(rng, 1, tlen, d, dfeat, dev)

        def run(m):
            return ops.rff_klms_bank_chunk(a["theta"], a["xs"], a["ys"],
                                           a["w"], a["b"], a["mu"], a["mask"],
                                           a["s"], mode=m)

        ms = {"cuda": [], "ref": []}
        for m in ("ref", "cuda", "cuda", "ref"):
            ms[m].append(time_ms(lambda: run(m), 20))
        prof = device_busy(lambda: [run("cuda") for _ in range(PROFILED_CALLS)],
                           named="klms")
        nbytes = 4 * (d * dfeat + 2 * dfeat + 2 * dfeat + tlen * (d + 4) + 1)
        bound, bound_by = bound_ms(nbytes, tlen * (2 * d * dfeat + 7 * dfeat))
        out[f"1x{tlen}x{d}->{dfeat}"] = {
            "ms": ms, "device_ms_a_call": prof["device_ms"] / PROFILED_CALLS,
            "bound_ms": bound, "bound_by": bound_by}
    return out


def policy_reads(dev) -> dict:
    """Phase 18's KLMS policy servers (the kernel server alone, each
    policy, installs timed as chip_smoke times them) over its request
    stream: read and write µs p50/p99 from the server's registry."""
    import chip_smoke as cs
    from repro_torch.serve import make_server

    seed = 0
    fm = cs.family_map("rff", seed, D_IN, D_FEAT, SIGMA, dev)
    kw = dict(feature_map=fm, bank=BANK, chunk=CHUNK, mu=MU,
              log_capacity=LOG_CAP, size_watermark=CHUNK, device=dev)
    requests = cs.policy_requests(np.random.default_rng(seed + 5),
                                  cs.POLICY_WRITES, D_IN)
    out = {}
    for policy in cs.POLICIES:
        srv = make_server("klms", policy=policy, rebuild_mode="blocked", **kw)
        cs.time_installs(srv)
        t0 = time.perf_counter()
        cs.serve_requests(srv, requests)
        torch.cuda.synchronize()
        hist = srv.metrics.snapshot()["histograms"]
        out[policy] = {
            kind: {k: hist[f"latency.{kind}"][k]
                   for k in ("p50", "p99", "mean", "count")}
            for kind in ("read_us", "write_us")}
        out[policy]["seconds"] = time.perf_counter() - t0
        del srv
    return out


def ops_times(dev) -> dict:
    """The replay ops of the imported package (whichever tree is on the
    path), each timed three times (medians of 30 calls; the small calls
    are host-bound, and the host's speed wanders): the KRLS element at
    both shapes, the KLMS element at the replay shape, the feature map at
    256 and 65536 rows, f32 and bf16, the read at one tenant (f32, bf16)
    and at the sharded KRLS predict's partial; and the reads' bits."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    out = {}
    for label, (d, dfeat, beta) in KRLS_SHAPES.items():
        a = feature_inputs(rng, LOG_CAP, d, dfeat, dev)
        ys = f32_tensor(rng, LOG_CAP, device=dev)
        out[f"krls_chunk_elements {label}"] = [time_ms(
            lambda: ops.rff_krls_chunk_elements(
                a["x"], ys, a["w"], a["b"], beta, a["s"], mode="cuda"), 30)
            for _ in range(3)]
    for m in (LOG_CAP, BANK * Q):
        a = feature_inputs(rng, m, D_IN, D_FEAT, dev)
        for prec in (None, "bf16"):
            out[f"rff_features {m} {prec or 'f32'}"] = [time_ms(
                lambda: ops.rff_features(a["x"], a["w"], a["b"], a["s"],
                                         mode="cuda", precision=prec), 30)
                for _ in range(3)]
        del a
    a = feature_inputs(rng, LOG_CAP, D_IN, D_FEAT, dev)
    ys = f32_tensor(rng, LOG_CAP, device=dev)
    out["klms_chunk_elements"] = [time_ms(
        lambda: ops.rff_klms_chunk_elements(
            a["x"], ys, a["w"], a["b"], 0.5, a["s"], mode="cuda"), 30)
        for _ in range(3)]
    theta = f32_tensor(rng, 1, D_FEAT, device=dev)
    for prec in (None, "bf16"):
        out[f"bank_predict one tenant {prec or 'f32'}"] = [time_ms(
            lambda: ops.rff_bank_predict(theta, a["x"][None, :Q], a["w"],
                                         a["b"], a["s"], mode="cuda",
                                         precision=prec), 30)
            for _ in range(3)]
    sp = inputs(np.random.default_rng(3), 1, Q, K_D_IN, 8192, dev)
    out["bank_predict shard partial"] = [time_ms(
        lambda: ops.rff_bank_predict(sp["theta"], sp["xs"], sp["w"],
                                     sp["b"], sp["s"], mode="cuda"), 30)
        for _ in range(3)]
    # The reads' bits (sha256 of the outputs) on inputs from a fixed seed:
    # the serving bank's read and one tenant's, f32 and bf16, for a
    # comparison of two trees.
    r = inputs(np.random.default_rng(4), BANK, Q, D_IN, D_FEAT, dev)
    out["read_sha256"] = {}
    for prec in (None, "bf16"):
        for label, sl in (("bank", slice(None)), ("tenant_5", slice(5, 6))):
            got = ops.rff_bank_predict(r["theta"][sl], r["xs"][sl], r["w"],
                                       r["b"], r["s"], mode="cuda",
                                       precision=prec)
            out["read_sha256"][f"{label} {prec or 'f32'}"] = hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()
    if hasattr(ops, "_dispatch"):
        # Host µs of one dispatch record and its (untraced) span, as the
        # read op makes it.
        def record():
            with ops._dispatch("bank_predict", bytes_moved=1.0,
                               shape=[1, Q, D_IN], dfeat=D_FEAT,
                               dtype=str(theta.dtype), mode="cuda",
                               precision=None):
                pass

        n = 20000
        out["dispatch_record_us"] = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                record()
            out["dispatch_record_us"].append(
                (time.perf_counter() - t0) / n * 1e6)
    return out


# The f32 flash route (csrc/flash_attention.cu), causal, at chip_smoke's
# shapes (BH, S, dh, dv): qwen2-0.5b's prefill at B = 4, deepseek's MLA
# head at B = 4, the launcher's reduced qwen2 (batch 8, 4 heads of 16 at
# S = 64); llama3-8b's head width for the tiles alone.
FLASH_F32_SHAPES = {"qwen2": (56, 2048, 64, 64), "mla": (64, 2048, 192, 128),
                    "launcher": (32, 64, 16, 16),
                    "llama3": (32, 1024, 128, 128)}
FLASH_SEEDS = (0, 1, 2)
FLASH_QK = "    for (int d = 0; d < dh; d += 4) {"
FLASH_PV = "    for (int s0 = 0; s0 < kKeys; s0 += 4) {"
FLASH_VARIANTS = {  # name: [(text, replacement, times)]
    "full": [],
    "no_exp": [("const float p = expf(__fsub_rn(s[i][j], m_new));",
                "const float p = __fsub_rn(s[i][j], m_new);", 1)],
    "no_qk": [(FLASH_QK, FLASH_QK.replace("d < dh", "d < 0"), 1)],
    "no_pv": [(FLASH_PV, FLASH_PV.replace("s0 < kKeys", "s0 < 0"), 1)],
    "qk_unroll_2": [(f"#pragma unroll(TM == 8 ? 1 : 2)\n{FLASH_QK}",
                     f"#pragma unroll 2\n{FLASH_QK}", 1)],
    "qk_unroll_4": [(f"#pragma unroll(TM == 8 ? 1 : 2)\n{FLASH_QK}",
                     f"#pragma unroll 4\n{FLASH_QK}", 1)],
    "pv_unroll_1": [(f"#pragma unroll 2\n{FLASH_PV}",
                     f"#pragma unroll 1\n{FLASH_PV}", 1)],
    "pv_unroll_4": [(f"#pragma unroll 2\n{FLASH_PV}",
                     f"#pragma unroll 4\n{FLASH_PV}", 1)],
    "skip_unit_corr": [(
        "      for (int c = 0; c < TD4; ++c) {\n"
        "        acc[i][c].x = __fmul_rn(acc[i][c].x, corr);",
        "      for (int c = 0; c < TD4; ++c) {\n"
        "        if (corr == 1.f) break;\n"
        "        acc[i][c].x = __fmul_rn(acc[i][c].x, corr);", 1)],
}


def flash_inputs(rng, shape, dev):
    bh, slen, dh, dv = shape
    return (f32_tensor(rng, bh, slen, dh, device=dev),
            f32_tensor(rng, bh, slen, dh, device=dev),
            f32_tensor(rng, bh, slen, dv, device=dev))


def flash_times(dev) -> dict:
    """``ops.flash_attention`` on f32 inputs (the CUDA-core route, causal)
    of the imported package, whichever tree is on the path, at each
    FLASH_F32_SHAPES entry but llama3's, inputs from each of FLASH_SEEDS:
    a median of 20 calls each (CUDA events around the call, its Python
    wrapper included) and, at the launcher's shape, whose call is
    host-bound, the kernel's device time per call over DECODE_CALLS calls
    (torch.profiler)."""
    from repro_torch.kernels import ops

    out = {}
    for name, shape in FLASH_F32_SHAPES.items():
        if name == "llama3":
            continue
        out[name] = []
        for seed in FLASH_SEEDS:
            q, k, v = flash_inputs(np.random.default_rng(seed), shape, dev)
            out[name].append(time_ms(
                lambda: ops.flash_attention(q, k, v, mode="cuda")))
            if name == "launcher":
                prof = device_busy(lambda: [
                    ops.flash_attention(q, k, v, mode="cuda")
                    for _ in range(DECODE_CALLS)])
                out.setdefault("launcher_device", []).append(
                    prof["device_ms"] / DECODE_CALLS)
            del q, k, v
    return out


def flash_breakdown(build, dev) -> dict:
    """The f32 flash kernel's tiles and FLASH_VARIANTS through its C entry
    (seed 0 inputs, causal): at every FLASH_F32_SHAPES entry, the source
    as it is at every (query rows, rows a thread) the kernel takes there,
    then each variant at the tile flash_plan picks, and the source
    again at that tile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.chunking import SMEM_BUDGET
    from repro_torch.kernels.flash_attention import (CUDA_CORE_KEYS,
                                                     CUDA_CORE_TILES,
                                                     _smem_bytes,
                                                     flash_attention_cuda,
                                                     flash_plan)

    libs = build_tiles(build, build.CSRC, build.BUILD_DIR / "breakdown",
                       {f"flash_{name}": ("flash_attention", edits)
                        for name, edits in FLASH_VARIANTS.items()})
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms, picked = {}, {}
    for label, shape in FLASH_F32_SHAPES.items():
        bh, slen, dh, dv = shape
        q, k, v = flash_inputs(np.random.default_rng(0), shape, dev)
        out = torch.empty_like(v)
        plan = flash_plan(q, k, v)
        picked[label] = (plan.query_tile, plan.thread_rows)

        def run(name, tile):
            fn = libs[f"flash_{name}"].flash_attention
            fn.argtypes = [P] * 4 + [I] * 5 + [F, I, I, P]
            if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  bh, slen, dh, dv, 1, dh ** -0.5, *tile, stream):
                raise SystemExit(f"flash {name} {tile}: launch failed")

        tiles = [tile for tile, cap in CUDA_CORE_TILES.items()
                 if dv <= cap and _smem_bytes("cuda_core", dh, dv,
                                              CUDA_CORE_KEYS, tile[0])
                 <= SMEM_BUDGET]
        runs = ([("full", t) for t in tiles]
                + [(n, picked[label]) for n in FLASH_VARIANTS if n != "full"]
                + [("full", picked[label])])
        for name, tile in runs:
            key = f"{label}/{name}/{'x'.join(map(str, tile))}"
            ms.setdefault(key, []).append(time_ms(lambda: run(name, tile), 10))
        # The same tile through the wrapper and through the op: the
        # host's share of a call.
        ms[f"{label}/wrapper"] = [time_ms(lambda: flash_attention_cuda(
            q, k, v)) for _ in range(2)]
        ms[f"{label}/op"] = [time_ms(lambda: ops.flash_attention(
            q, k, v, mode="cuda")) for _ in range(2)]
        del q, k, v, out
    return {"shapes": FLASH_F32_SHAPES, "picked": picked, "ms": ms}


# The compact KRLS route's launches (csrc/krls_compact.cu run): the
# features, P_0 Z^T, the recursion, the rank-L update, then the fix-up's
# three launches. Each variant stops the call after a phase (its later
# launches prefixed ``if (0)``), so no launch reads what an earlier one
# skipped.
_FIX_LAUNCHES = [
    ("      compact_product_fix_kernel<<<",
     "      if (0) compact_product_fix_kernel<<<", 1),
    ("      compact_recursion_kernel<<<Bs, kRecThreads, 0, st>>>(\n"
     "          theta, theta_out,",
     "      if (0) compact_recursion_kernel<<<Bs, kRecThreads, 0, st>>>(\n"
     "          theta, theta_out,", 1),
    ("      compact_update_fix_kernel<<<",
     "      if (0) compact_update_fix_kernel<<<", 1)]
_UPDATE = [("      compact_update_kernel<<<",
            "      if (0) compact_update_kernel<<<", 1)]
_RECURSION = [("      compact_recursion_kernel<<<Bs, kRecThreads, 0, st>>>(\n"
               "          th, theta_out,",
               "      if (0) compact_recursion_kernel<<<Bs, kRecThreads, 0, "
               "st>>>(\n          th, theta_out,", 1)]
_PRODUCT = [("      compact_product_kernel<<<",
             "      if (0) compact_product_kernel<<<", 1)]
COMPACT_VARIANTS = {
    "compact_full": ("krls_compact", []),
    "compact_no_fixup": ("krls_compact", _FIX_LAUNCHES),
    "compact_upto_recursion": ("krls_compact", _FIX_LAUNCHES + _UPDATE),
    "compact_upto_product": ("krls_compact",
                             _FIX_LAUNCHES + _UPDATE + _RECURSION),
    "compact_features_only": ("krls_compact", _FIX_LAUNCHES + _UPDATE
                              + _RECURSION + _PRODUCT),
}
COMPACT_SHAPES = [(BANK, CHUNK, K_D_IN, 400), (BANK, 1, K_D_IN, 400),
                  (BANK, CHUNK, K_D_IN, 1024), (BANK, 1, K_D_IN, 1024)]
# The Tc study: lockstep calls of TC_STUDY_T ticks at the paper's section 6
# settings, six calls a tenant, TC_STUDY_B tenants at D = 400.
TC_STUDY = (16, 32, 64, 128)
TC_STUDY_B, TC_STUDY_T, TC_STUDY_CALLS = 64, 128, 6


# The route crossover study: tenants, ticks a call and (d, D) widths at
# which both chunk routes of kernel 4 take the shape.
CROSSOVER_BANKS = (1, 8, 64, 132, 256, 1024)
CROSSOVER_TICKS = (1, 2, 4, 8, 16, 64, 512)
CROSSOVER_WIDTHS = ((5, 31), (5, 100), (5, 200), (5, 300), (5, 335),
                    (128, 256))


def route_crossover(dev) -> dict:
    """Both chunk routes at D <= 335 forced through the wrapper, in turns
    (resident, compact, compact, resident), with the step wrapper's two at
    T = 1: each shape's medians, the faster route, the route
    krls_chunk_route picks and the picked route's time over the faster's."""
    from repro_torch.kernels.rff_krls_step import (
        krls_chunk_route,
        rff_krls_bank_chunk_cuda,
        rff_krls_bank_step_cuda,
    )

    rng = np.random.default_rng(3)
    routes = ("resident", "compact")
    out = {}
    for d, dfeat in CROSSOVER_WIDTHS:
        big = krls_inputs(rng, max(CROSSOVER_BANKS), max(CROSSOVER_TICKS), d,
                          dfeat, dev, "eye")
        for bank in CROSSOVER_BANKS:
            for tlen in CROSSOVER_TICKS:
                theta, pmat, beta = (big[k][:bank] for k in
                                     ("theta", "pmat", "beta"))
                xs = big["xs"][:bank, :tlen].contiguous()
                ys = big["ys"][:bank, :tlen].contiguous()
                common = (big["w"], big["b"], beta)
                calls = {"chunk": lambda r: rff_krls_bank_chunk_cuda(
                    theta, pmat, xs, ys, *common, None, big["s"], _route=r)}
                if tlen == 1:
                    x, y = xs[:, 0].contiguous(), ys[:, 0].contiguous()
                    calls["step"] = lambda r: rff_krls_bank_step_cuda(
                        theta, pmat, x, y, *common, big["s"], _route=r)
                reps = 10 if bank * tlen <= 16384 else 3
                picked = krls_chunk_route(bank, tlen, dfeat, d)
                for kind, call in calls.items():
                    ms = {r: [] for r in routes}
                    for r in (*routes, *routes[::-1]):
                        ms[r].append(time_ms(lambda: call(r), reps))
                    best = {r: min(v) for r, v in ms.items()}
                    faster = min(best, key=best.get)
                    out[f"{kind} B{bank} T{tlen} d{d} D{dfeat}"] = {
                        "ms": ms, "faster": faster, "picked": picked,
                        "picked_over_faster": best[picked] / best[faster]}
        del big
        torch.cuda.empty_cache()
    return out


def compact_breakdown(build, dev) -> dict:
    """``krls_bank_chunk_compact`` by phase at COMPACT_SHAPES (P = I / lam,
    every tick live): each variant of COMPACT_VARIANTS through the C entry
    with the wrapper's workspace, ``compact_full`` first and last, and the
    streaming route's C entry on the same inputs."""
    from repro_torch.kernels import rff_krls_step
    from repro_torch.kernels.chunking import (KRLS_COMPACT_TC,
                                              krls_compact_slab,
                                              krls_compact_workspace_bytes)

    libs = build_tiles(build, build.CSRC, build.BUILD_DIR / "breakdown",
                       COMPACT_VARIANTS)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for lib in libs.values():
        lib.krls_bank_chunk_compact.argtypes = (
            [P] * 13 + [I] * 4 + [P] + [P, L, I])
    streaming = rff_krls_step._lib().krls_bank_chunk
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for bank, tlen, d, dfeat in COMPACT_SHAPES:
        a = krls_inputs(np.random.default_rng(0), bank, tlen, d, dfeat, dev,
                        "eye")
        outs = [torch.empty_like(a["theta"]), torch.empty_like(a["pmat"]),
                torch.empty_like(a["ys"]), torch.empty_like(a["ys"])]
        slab = krls_compact_slab(bank, tlen, d, dfeat)
        nbytes = krls_compact_workspace_bytes(slab, min(KRLS_COMPACT_TC, tlen),
                                              d, dfeat)
        ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        args = (*(a[k].data_ptr() for k in ("theta", "pmat", "xs", "ys")),
                None, *(a[k].data_ptr() for k in ("beta", "w", "b", "s")),
                *(o.data_ptr() for o in outs), bank, tlen, d, dfeat, stream)

        def launch(name):
            if name == "streaming":
                code = streaming(*args)
            else:
                code = libs[name].krls_bank_chunk_compact(
                    *args, ws.data_ptr(), nbytes, slab)
            if code:
                raise SystemExit(f"{name} failed: cudaError {code}")

        ms = {name: [] for name in (*COMPACT_VARIANTS, "streaming")}
        for name in (*COMPACT_VARIANTS, "streaming", "compact_full"):
            ms[name].append(time_ms(lambda: launch(name),
                                    3 if name == "streaming" else 10))
        best = {name: min(v) for name, v in ms.items()}
        out[f"{bank}x{tlen}x{d}x{dfeat}"] = {
            "ms": ms, "slab": slab,
            "phase_ms": {
                "features": best["compact_features_only"],
                "product": best["compact_upto_product"]
                - best["compact_features_only"],
                "recursion": best["compact_upto_recursion"]
                - best["compact_upto_product"],
                "update": best["compact_no_fixup"]
                - best["compact_upto_recursion"],
                "fixup_no_op": best["compact_full"] - best["compact_no_fixup"]}}
        del a, outs, ws
        torch.cuda.empty_cache()
    return out


def tc_study(dev) -> dict:
    """How far the compact form's f32 results lie from a float64 tick run
    at lam = 1e-4 for each Tc in TC_STUDY (its plain version; on the card
    also the kernel), against the tick form's own f32
    distance (the budget rule of chip_smoke.within_budget: the kernel is
    allowed twice that, plus 1e-5): theta and every prior error normwise, P
    as a share of each tenant's max |P|, over TC_STUDY_CALLS calls of
    TC_STUDY_T ticks (masks random, 70% live) at D = 400."""
    from chip_smoke import K_SIGMA, normwise, p_rel
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    bank, tlen, dfeat = TC_STUDY_B, TC_STUDY_T, 400
    w = rng.normal(size=(K_D_IN, dfeat)) / K_SIGMA
    b = rng.uniform(0, 2 * np.pi, size=dfeat)
    dirs = rng.normal(size=(bank, K_D_IN)) / np.sqrt(K_D_IN)
    calls = []
    for _ in range(TC_STUDY_CALLS):
        xs = rng.normal(size=(bank, tlen, K_D_IN))
        ys = 1.0 + 0.5 * np.sin(np.einsum("btd,bd->bt", xs, dirs))
        calls.append((xs, ys, rng.random((bank, tlen)) < 0.7))

    def serve(fn, dtype, **kw):
        def t(v):
            return torch.from_numpy(np.asarray(v, np.float32)).to(dev, dtype)
        theta = torch.zeros(bank, dfeat, dtype=dtype, device=dev)
        pmat = (torch.eye(dfeat, dtype=dtype, device=dev) / K_LAM).expand(
            bank, dfeat, dfeat).contiguous()
        s = ref.default_scale(dfeat, dtype, dev)
        errs = []
        for xs, ys, mask in calls:
            theta, pmat, _, err = fn(theta, pmat, t(xs), t(ys), t(w), t(b),
                                     K_BETA, t(mask), s, **kw)
            errs.append(err[torch.from_numpy(mask).to(dev)])
        return theta, pmat, torch.cat(errs)[None]

    exact = serve(ref.rff_krls_bank_chunk_ref, torch.float64)
    plain = serve(ref.rff_krls_bank_chunk_ref, torch.float32)
    dists = (normwise, p_rel, normwise)
    names = ("theta", "P", "prior_errors")
    out = {"tick_f32": {n: f(g, x) for n, f, g, x in
                        zip(names, dists, plain, exact)}}
    runs = {f"compact_tc{tc}": (ref.krls_chunk_compact_ref, {"tc": tc})
            for tc in TC_STUDY}
    if dev.type == "cuda":  # the kernel itself, Tc = KRLS_COMPACT_TC
        from repro_torch.kernels.rff_krls_step import rff_krls_bank_chunk_cuda

        runs["compact_kernel"] = (rff_krls_bank_chunk_cuda,
                                  {"_route": "compact"})
    for label, (fn, kw) in runs.items():
        got = serve(fn, torch.float32, **kw)
        out[label] = {
            n: {"vs_f64": f(g, x), "ratio_to_tick": f(g, x)
                / out["tick_f32"][n]}
            for n, f, g, x in zip(names, dists, got, exact)}
    out["setting"] = {"B": bank, "T": tlen, "calls": TC_STUDY_CALLS,
                      "d": K_D_IN, "D": dfeat, "lam": K_LAM, "beta": K_BETA,
                      "sigma": K_SIGMA, "live": 0.7}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("krls_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if len(sys.argv) == 3 and sys.argv[1] == "--flash":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        print(smi)
        print(json.dumps({"flash_times": flash_times(dev),
                          "src": sys.argv[2]}))
        return 0
    if sys.argv[1:] == ["--flash-variants"]:
        sys.path.insert(0, str(SRC))
        from repro_torch.kernels import _build

        print(smi)
        print(json.dumps({"flash": flash_breakdown(_build, dev)}))
        return 0
    if sys.argv[1:] == ["--compact"]:
        sys.path.insert(0, str(SRC))
        from repro_torch.kernels import _build

        print(smi)
        print(json.dumps({"compact": compact_breakdown(_build, dev)}))
        print(json.dumps({"compact_tc": tc_study(dev)}))
        return 0
    if sys.argv[1:] == ["--route-crossover"]:
        sys.path.insert(0, str(SRC))
        print(smi)
        print(json.dumps({"route_crossover": route_crossover(dev)}))
        return 0
    if sys.argv[1:] == ["--predict-few"]:
        sys.path.insert(0, str(SRC))
        from repro_torch.kernels import _build

        print(smi)
        print(json.dumps({"predict_few": predict_few_breakdown(_build, dev)}))
        print(json.dumps({"predict_route_study": predict_route_study(dev)}))
        print(json.dumps({"klms_b1": klms_b1_times(dev)}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--policy":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        print(smi)
        print(json.dumps({"policy_reads": policy_reads(dev),
                          "src": sys.argv[2]}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ops":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        print(smi)
        print(json.dumps({"ops_times": ops_times(dev), "src": sys.argv[2]}))
        return 0
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    print(smi)
    print(json.dumps({"attention": attention_breakdown(_build, dev)}))
    fns = build_all(_build, _build.CSRC, _build.BUILD_DIR / "breakdown")
    a = krls_inputs(np.random.default_rng(0), BANK, CHUNK, K_D_IN, K_D_FEAT,
                    dev, "eye")
    outs = [torch.empty_like(a["theta"]), torch.empty_like(a["pmat"]),
            torch.empty_like(a["ys"]), torch.empty_like(a["ys"])]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, tlen):
        code = fn(*(a[k].data_ptr() for k in ("theta", "pmat", "xs", "ys")),
                  None, *(a[k].data_ptr() for k in ("beta", "w", "b", "s")),
                  *(o.data_ptr() for o in outs), BANK, tlen, K_D_IN,
                  K_D_FEAT, stream)
        if code:
            raise SystemExit(f"launch failed: cudaError {code}")

    ms = {name: [] for name in VARIANTS}
    ms_t1 = {name: [] for name in VARIANTS}
    for name in [*VARIANTS, "full"]:
        ms[name].append(time_ms(lambda: launch(fns[name], CHUNK), 10))
        ms_t1[name].append(time_ms(lambda: launch(fns[name], 1), 10))
    full = min(ms["full"])
    print(json.dumps({
        "shape": {"B": BANK, "T": CHUNK, "d": K_D_IN, "D": K_D_FEAT},
        "ms": ms, "ms_T1": ms_t1,
        "share_of_full_ms": {name: full - min(v) for name, v in ms.items()
                             if name != "full"}}))
    print(json.dumps({"feature_tile": tile_breakdown(_build, dev)}))
    print(json.dumps({"klms_element": element_breakdown(dev)}))
    print(json.dumps({"krls_element": krls_element_breakdown(dev)}))
    print(json.dumps({"features": features_breakdown(dev)}))
    print(json.dumps({"krls_readmit": readmit_breakdown(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
