#!/usr/bin/env python3
"""The port's distribution tier on four cards under NCCL, one rank a card.

Run from the root of a checkout on a host with four GPUs:

    torchrun --standalone --nproc-per-node 4 dist_smoke.py [--seed N]

Rank 0 builds the kernels of this path (``src/repro_torch/csrc``:
the feature map, the read and the KLMS chunk) while the others wait. Then
every rank runs ``chip_smoke.py``'s phase-20 rank body (``dist_work``) at
its parts (a) sharded KRLS at tests/test_krls_sharded.py's shape, per tick
and in blocks of 8 and 32, (b) sharded KRLS at D = 32768 (lam 1e-2 and
1e-4; ms a tick, all_reduce ms a tick, peak bytes a rank) and (d)
diffusion KLMS at four nodes, with the all_reduces on NCCL and host copies
on a gloo group. After the process group is gone, rank 0 holds the results
against the dense and plain runs on its card (``dist_controls``, the same
bounds as phase 20) and prints one JSON line of figures, each card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PARTS = "abd"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dist_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "LOCAL_RANK" not in os.environ:
        print("dist_smoke: run under torchrun --standalone "
              "--nproc-per-node 4", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"dist_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", device_id=device)
    cpu = dist.new_group(backend="gloo")
    rank = dist.get_rank()
    t_run = time.perf_counter()
    try:
        if rank == 0:
            _build.build(("rff_features", "bank_predict", "klms_bank"))
        dist.barrier(group=cpu)
        inp = cs.dist_inputs(args.seed)
        t0 = time.perf_counter()
        res = cs.dist_work(inp, PARTS, cpu_group=cpu)
        ranks_s = time.perf_counter() - t0
        dist.barrier(group=cpu)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0
    launches = {n: int(sum(res[f"launches_{n}"])) for n in cs.DIST_KERNELS}
    for n, count in launches.items():
        cs.check(count > 0, f"kernel {n} was not launched by the ranks")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    figures = cs.dist_controls(inp, res, device, PARTS)
    control_parts = figures.pop("seconds")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    cs.emit({"phase": "distribution_nccl", "world": res["world"],
             "backend": res["backend"], "one_rank_a_card": True, **figures,
             "launches": launches,
             "seconds": {"ranks": ranks_s, "rank_parts": res["seconds"],
                         "controls": time.perf_counter() - t0,
                         "control_parts": control_parts,
                         "total": time.perf_counter() - t_run},
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "cards": smi})
    for line in smi:
        print(line)
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
