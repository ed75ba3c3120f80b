#!/usr/bin/env python3
"""Where the resident KRLS chunk kernel's time goes, on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and
``nvcc``: ``python3 krls_breakdown.py``.

It compiles timing-only variants of ``src/repro_torch/csrc/krls_bank.cu``
into ``build/repro_torch/breakdown/``, each with one part of the resident
tick removed or changed (so their results are wrong and are not checked),
and times ``krls_bank_chunk_resident`` at the KRLS serving shape (B = 1024,
T = 16, d = 5, D = 300, P = I / lam, no mask) and at T = 1 with
``chip_smoke.time_ms``, the full kernel first and last. The full kernel's
time less a variant's is that part's share. A variant whose text no longer
matches the source stops the run. It prints the card's name and power
limit and one JSON line.

Variants:
  no_downdate  the downdate of the ticks after the first live one skipped;
  no_pz_reads  pz's triangle reads (and their addressing) skipped, the
               multiply-add chain kept;
  no_divides   the downdate's divides made multiplies;
  unroll_2, unroll_4  the downdate loops unrolled by 2 or 4;
  threads_512, threads_768  a block of 512 or 768 threads (16, 24 warps).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (BANK, CHUNK, K_D_FEAT, K_D_IN, SRC, krls_inputs,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("krls_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    fns = build_all(_build, _build.CSRC, _build.BUILD_DIR / "breakdown")
    dev = torch.device("cuda", 0)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
