"""Rank body of the port's distribution tests: sharded KRLS and diffusion
KLMS on ``torch.distributed``.

    PYTHONPATH=src python tests/torch_dist_ranks.py WORLD DEVICE JOB IN OUT

spawns WORLD processes that join one gloo process group (through a file
beside OUT) and build the KRLS mesh on DEVICE ("cpu", or "cuda": gloo's
all_reduce takes CUDA tensors, and several ranks may share one card, which
NCCL refuses). Each rank reads the job's inputs from IN (``.npz``) and
runs JOB; rank 0 writes the results to OUT (``.npz``). Jobs:

* ``krls``: ``sharded_krls_run`` at every ``lams`` x ``ks`` (k = 1: one
  all_reduce a tick, else one a k-tick block), counting the all_reduces;
  with ``gather_p`` the gathered state after each run;
* ``parity``: ``krls``, again in float64 at ``f64_lams`` x ``f64_ks``, the
  step, block-step and predict functions, the learner, the placements, a
  ``repro`` state carried in through ``convert.sharded_rls_state`` and the
  raises;
* ``diffusion``: ``diffusion_klms_run`` for each ``(combine_every,
  compress)`` of ``runs``, and with ``head`` an int8 run, combining every
  tick, of the streams' first ``head`` ticks.

The file imports neither JAX nor ``repro``: the card tests
(``tests/test_torch_cuda.py``) run it too.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _count_all_reduce():
    """Wrap ``dist.all_reduce`` (the name the port calls) with a counter."""
    calls = [0]
    inner = dist.all_reduce

    def counting(*args, **kw):
        calls[0] += 1
        return inner(*args, **kw)

    dist.all_reduce = counting
    return calls


def _trig(inp, device, dtype):
    from repro_torch import convert

    tf = convert.trig_features(inp["omega"], inp["bias"], device=device)
    return type(tf)(*(a.to(dtype) for a in tf))


def _krls(mesh, inp, device, out, calls, prefix=""):
    """Every ``{prefix}lams`` x ``{prefix}ks`` run (``prefix="f64_"``: the
    map and the first ``f64_ticks`` of the stream in float64). Returns the
    first lam's per-tick state."""
    from repro_torch import convert
    from repro_torch.core.krls import sharded_krls_run

    dtype = torch.float64 if prefix == "f64_" else torch.float32
    tf = _trig(inp, device, dtype)
    ticks = int(inp.get(f"{prefix}ticks", len(inp["xs"])))
    xs = torch.as_tensor(inp["xs"][:ticks], dtype=dtype, device=device)
    ys = torch.as_tensor(inp["ys"][:ticks], dtype=dtype, device=device)
    kept = None
    for i, lam in enumerate(inp[f"{prefix}lams"]):
        for k in inp[f"{prefix}ks"]:
            before = calls[0]
            state, outs = sharded_krls_run(mesh, tf, xs, ys, lam=float(lam),
                                           beta=float(inp["beta"]),
                                           combine_every=int(k))
            key = f"{prefix}lam{i}_k{k}"
            out[f"count_{key}"] = calls[0] - before
            out[f"pred_{key}"] = outs.prediction.cpu().numpy()
            out[f"err_{key}"] = outs.error.cpu().numpy()
            if int(inp.get("gather_p", 0)):
                theta, pmat, step = convert.gather_rls_state(state)
                out[f"theta_{key}"] = theta
                out[f"pmat_{key}"] = pmat
                out[f"step_{key}"] = step
            if i == 0 and k == 1:
                kept = state
            del state
    return kept


def _diffusion(mesh, inp, device, out):
    from repro_torch import convert
    from repro_torch.core.distributed import diffusion_klms_run

    rff = convert.trig_features(inp["d_omega"], inp["d_bias"], device=device)
    xs = torch.as_tensor(inp["d_xs"], device=device)
    ys = torch.as_tensor(inp["d_ys"], device=device)
    for i, (every, compress) in enumerate(inp["runs"]):
        theta, errs = diffusion_klms_run(mesh, "shard", rff, xs, ys,
                                         float(inp["mu"]), int(every),
                                         bool(compress))
        out[f"theta_run{i}"] = convert.gather(theta)
        out[f"errs_run{i}"] = convert.gather(errs)
        out[f"placements_run{i}"] = str((theta.placements, errs.placements))
    if "head" in inp:  # the int8 run over its first combines alone
        head = int(inp["head"])
        theta, _ = diffusion_klms_run(mesh, "shard", rff, xs[:, :head],
                                      ys[:, :head], float(inp["mu"]), 1, True)
        out["head_theta"] = convert.gather(theta)


def _raises(fn) -> str:
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e).__name__
    return "none"


def _parity(mesh, inp, device, out, calls):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import convert
    from repro_torch.core.distributed import diffusion_klms_run
    from repro_torch.core.krls import (
        make_sharded_krls_block_step,
        make_sharded_krls_predict,
        make_sharded_krls_step,
        shard_krls_rff,
        sharded_krls_init,
        sharded_krls_run,
    )
    from repro_torch.core.learner import sharded_krls_learner
    from repro_torch.features import taylor_map

    run_state = _krls(mesh, inp, device, out, calls)
    _krls(mesh, inp, device, out, calls, prefix="f64_")
    tf = _trig(inp, device, torch.float32)
    xs = torch.as_tensor(inp["xs"], device=device)
    ys = torch.as_tensor(inp["ys"], device=device)
    lam, beta = float(inp["lams"][0]), float(inp["beta"])
    n = xs.shape[0]

    # the step and block-step functions against the runs, bit for bit: 64
    # steps against the run's first 64 ticks (and a run of them for P),
    # the n // 8 blocks of 8 against the k = 8 run
    head = 64
    step = make_sharded_krls_step(mesh, tf, beta)
    state = sharded_krls_init(mesh, tf.num_features, lam)
    preds = []
    for t in range(head):
        before = calls[0]
        state, o = step(state, xs[t], ys[t])
        out["step_calls"] = calls[0] - before
        preds.append(o.prediction)
    head_state, _ = sharded_krls_run(mesh, tf, xs[:head], ys[:head],
                                     lam=lam, beta=beta)
    out["step_equals_run"] = bool(
        np.array_equal(torch.stack(preds).cpu().numpy(),
                       out["pred_lam0_k1"][:head])
        and torch.equal(state.pmat.to_local(), head_state.pmat.to_local()))
    k = 8
    block = make_sharded_krls_block_step(mesh, tf, beta, combine_every=k)
    state = sharded_krls_init(mesh, tf.num_features, lam)
    preds = []
    for start in range(0, n - n % k, k):
        state, o = block(state, xs[start:start + k], ys[start:start + k])
        preds.append(o.prediction)
    out["block_step_equals_run"] = bool(np.array_equal(
        torch.cat(preds).cpu().numpy(), out["pred_lam0_k8"][:n - n % k]))
    out["block_step_count"] = int(state.step.to_local())
    predict = make_sharded_krls_predict(mesh, tf)
    before = calls[0]
    out["run_predict"] = predict(run_state, xs[40]).cpu().numpy()
    out["predict_calls"] = calls[0] - before
    out["run_predict_block"] = predict(run_state, xs[40:48]).cpu().numpy()

    # the learner adapter
    lrn = sharded_krls_learner(mesh, tf, lam=lam, beta=beta)
    state = lrn.init()
    preds = []
    for t in range(32):
        state, o = lrn.step(state, xs[t], ys[t])
        preds.append(o.prediction)
    out["learner_pred"] = torch.stack(preds).cpu().numpy()
    out["learner_predict"] = lrn.predict(state, xs[40]).cpu().numpy()
    specs = (state.theta.placements, state.pmat.placements,
             state.step.placements)
    out["state_placements_ok"] = specs == ((Shard(0),), (Shard(0),),
                                           (Replicate(),))
    sharded = shard_krls_rff(mesh, tf)
    out["feature_placements_ok"] = (
        sharded.omega.placements == (Shard(1),)
        and sharded.bias.placements == (Shard(0),)
        and tuple(sharded.omega.shape) == tuple(tf.omega.shape)
        and tuple(state.pmat.shape) == (tf.num_features,) * 2
        and tuple(state.pmat.to_local().shape)
        == (tf.num_features // dist.get_world_size(), tf.num_features))

    # a repro state at tick `cut`, carried onto the mesh, runs the rest
    cut = int(inp["cut"])
    carried = convert.sharded_rls_state(inp["ref_theta_cut"],
                                        inp["ref_pmat_cut"],
                                        inp["ref_step_cut"], mesh)
    state, o = sharded_krls_run(mesh, tf, xs[cut:], ys[cut:], lam=lam,
                                beta=beta, state=carried)
    out["carried_pred"] = o.prediction.cpu().numpy()
    out["carried_step"] = convert.gather(state.step)
    out["carried_input_kept"] = bool(np.array_equal(
        convert.gather(carried.pmat), inp["ref_pmat_cut"]))

    out["raise_taylor"] = _raises(lambda: shard_krls_rff(
        mesh, taylor_map(5, 2, 5.0, device=device)))
    out["raise_divide"] = _raises(lambda: sharded_krls_init(mesh, 255))
    out["raise_nodes"] = _raises(lambda: diffusion_klms_run(
        mesh, "shard", tf, torch.zeros(8, 3, 5, device=device),
        torch.zeros(8, 3, device=device), 0.5))


def _rank(rank: int, world: int, device: str, job: str, inp_path: str,
          out_path: str, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_krls_mesh

        mesh = make_krls_mesh(device_type=device)
        inp = dict(np.load(inp_path, allow_pickle=False))
        out: dict = {}
        calls = _count_all_reduce()
        if job == "krls":
            _krls(mesh, inp, device, out, calls)
        elif job == "parity":
            _parity(mesh, inp, device, out, calls)
        elif job == "diffusion":
            _diffusion(mesh, inp, device, out)
        else:
            raise ValueError(f"unknown job {job!r}")
        if rank == 0:
            np.savez(out_path, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    world, device, job, inp_path, out_path = argv
    init_file = str(Path(out_path).with_suffix(".init"))
    mp.start_processes(_rank, args=(int(world), device, job, inp_path,
                                    out_path, init_file),
                       nprocs=int(world), join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
