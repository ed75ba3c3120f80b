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
on a gloo group. Then (e) ``chip_smoke.py``'s phase-22 (c) model,
deepseek-v2-lite-16b at 2 of its 27 layers under its train mapping (fsdp),
takes one train step (B = 4, S = 2048, one microbatch) with its state as
DTensors on a (4, 1) ("data", "model") mesh, params and moments placed by
``param_specs``/``moment_specs``, the batch over the data axis and
kernel 11 through the DTensor boundary. After the process group is gone,
rank 0 holds the results against the dense and plain runs on its card
(``dist_controls``, the same bounds as phase 20), and (e) against the same
step on one card: each leaf's new first moment (the step's gradient
times 1 - b1) and the loss within LM_BUDGET times the one-card bf16
step's own distance from an f32 copy of it plus LM_BUDGET_FLOOR of the
f32 value (phase 21's budget rule), with the MoE routes' flips between the
runs counted. It prints one JSON line of figures, each card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero.
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
# (e): phase 22 (c)'s cut of deepseek-v2-lite-16b and its batch.
FSDP_ARCH, FSDP_LAYERS, FSDP_B, FSDP_S = "deepseek-v2-lite-16b", 2, 4, 2048


def fsdp_state(seed, device):
    """(e)'s config (train mapping), random state and batch, the same on
    every rank and on the control card."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.lm_data import batch_at_step
    from repro_torch.launch.specs import resolve_cell
    from repro_torch.train.steps import init_train_state

    cfg, note = resolve_cell(replace(get_config(FSDP_ARCH),
                                     num_layers=FSDP_LAYERS),
                             SHAPES["train_4k"])
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, cfg, device=device)
    tokens = batch_at_step(seed, 0, global_batch=FSDP_B, seq_len=FSDP_S,
                           vocab=cfg.vocab_size, device=device)
    return cfg, note, state, {"tokens": tokens}


def fsdp_work(seed, device, cs, flash) -> dict:
    """(e) on every rank: the step on the (world, 1) mesh. Rank 0 keeps the
    whole new first moments, the loss and grad norm, the routes it saw."""
    from dataclasses import replace

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import AdamWState
    from repro_torch.optim.tree import leaves
    from repro_torch.train.steps import make_train_step

    cfg, note, state, batch = fsdp_state(seed, device)
    mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     device_type=device.type)
    baxes = specs.train_batch_axes(
        cfg, ShapeSpec("train", FSDP_S, FSDP_B, "train"), mesh)
    pinned = replace(cfg, activation_batch_axes=baxes)
    pspec = sharding.param_specs(pinned, mesh, state["params"])
    mspec = sharding.moment_specs(pinned, mesh, state["params"])
    dstate = {"params": sharding.distribute(state["params"], mesh, pspec),
              "opt": AdamWState(m=sharding.distribute(state["opt"].m, mesh,
                                                      mspec),
                                v=sharding.distribute(state["opt"].v, mesh,
                                                      mspec),
                                count=state["opt"].count),
              "step": state["step"]}
    sharded = sum(any(type(p).__name__ != "Replicate" for p in t.placements)
                  for t in leaves(dstate["params"]))
    del state
    torch.cuda.empty_cache()
    step = make_train_step(pinned, num_microbatches=1, peak_lr=3e-4,
                           batch_axes=baxes, grad_specs=pspec)
    routes: list = []
    flash.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cs.route_log(routes):
        new, metrics = step(dstate, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = flash.launches
    moments = [t.full_tensor().float().cpu() for t in leaves(new["opt"].m)]
    loss = float(metrics["loss"].full_tensor()
                 if hasattr(metrics["loss"], "full_tensor")
                 else metrics["loss"])
    # The MoE routes each rank's own batch rows (its shard of the data
    # axis, in rank order): gather them into the batch's.
    whole = []
    for r in routes:
        parts = [torch.empty_like(r) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, r.contiguous())
        whole.append(torch.cat(parts).cpu())
    routes = whole
    return {"policy": note, "batch_axes": list(baxes), "moments": moments,
            "loss": loss, "routes": routes, "step_ms": step_ms,
            "launches": launches, "sharded_param_leaves": sharded,
            "leaves": len(moments)}


def fsdp_controls(seed, device, cs, got) -> dict:
    """(e) on rank 0's card: the one-card bf16 step and an f32 copy's step;
    the sharded step's moments and loss within the budget rule."""
    from dataclasses import replace

    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.optim.tree import leaves
    from repro_torch.train.steps import make_train_step

    cfg, _, state, batch = fsdp_state(seed, device)
    routes: list = []
    with cs.route_log(routes):
        one, one_m = make_train_step(cfg, num_microbatches=1,
                                     peak_lr=3e-4)(state, batch)
    want = [t.float() for t in leaves(one["opt"].m)]
    del one
    cfg32 = replace(cfg, dtype="float32")
    p32 = cs.as_f32(state["params"])
    state32 = {"params": p32, "opt": adamw_init(p32, cfg32.opt_dtype),
               "step": state["step"]}
    del state
    torch.cuda.empty_cache()
    exact, exact_m = make_train_step(cfg32, num_microbatches=1,
                                     peak_lr=3e-4)(state32, batch)
    exact_moments = leaves(exact["opt"].m)
    worst = 0.0
    for i, (g, w, e) in enumerate(zip(got["moments"], want, exact_moments)):
        g = g.to(device)
        d_s, d_p = float((g - w).norm()), float((w - e).norm())
        allowed = cs.LM_BUDGET * d_p + cs.LM_BUDGET_FLOOR * float(e.norm())
        cs.check(d_s <= allowed, f"fsdp: moment {i} {tuple(g.shape)} "
                 f"{d_s:.3g} from one card, one card {d_p:.3g} from f32")
        worst = max(worst, d_s / allowed if allowed else 0.0)
    loss1, loss32 = float(one_m["loss"]), float(exact_m["loss"])
    cs.check(abs(got["loss"] - loss1) <= cs.LM_BUDGET * abs(loss1 - loss32)
             + cs.LM_BUDGET_FLOOR * abs(loss32),
             f"fsdp: loss {got['loss']} vs one card {loss1} (f32 {loss32})")
    flips = cs.route_flips(got["routes"], [r.cpu() for r in routes])
    return {"loss_sharded": got["loss"], "loss_one_card": loss1,
            "loss_f32": loss32, "worst_share_of_budget": worst,
            "route_flip_share": flips}


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
            _build.build(("rff_features", "bank_predict", "klms_bank",
                          "flash_attention", "flash_attention_sm90"))
        dist.barrier(group=cpu)
        inp = cs.dist_inputs(args.seed)
        t0 = time.perf_counter()
        res = cs.dist_work(inp, PARTS, cpu_group=cpu)
        ranks_s = time.perf_counter() - t0
        dist.barrier(group=cpu)
        from repro_torch.kernels.flash_attention import flash_attention_cuda

        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        fsdp = fsdp_work(args.seed + 26, device, cs, flash_attention_cuda)
        fsdp_s = time.perf_counter() - t0
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
    cs.check(fsdp["launches"] == FSDP_LAYERS,
             f"fsdp: {fsdp['launches']} kernel 11 launches on rank 0, not "
             f"{FSDP_LAYERS}")
    t1 = time.perf_counter()
    fsdp_hold = fsdp_controls(args.seed + 26, device, cs, fsdp)
    fsdp_record = {"arch": FSDP_ARCH, "layers": FSDP_LAYERS, "B": FSDP_B,
                   "S": FSDP_S, "mesh": [res["world"], 1],
                   **{k: fsdp[k] for k in ("policy", "batch_axes", "step_ms",
                                           "launches", "leaves",
                                           "sharded_param_leaves")},
                   **fsdp_hold, "tolerance": {
                       "factor": cs.LM_BUDGET,
                       "floor_of_f32_norm": cs.LM_BUDGET_FLOOR},
                   "seconds": {"ranks": fsdp_s,
                               "controls": time.perf_counter() - t1}}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    cs.emit({"phase": "distribution_nccl", "world": res["world"],
             "backend": res["backend"], "one_rank_a_card": True, **figures,
             "launches": launches, "fsdp_train": fsdp_record,
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
