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
  tick, of the streams' first ``head`` ticks;
* ``train``: for each arch of ``archs`` (reduced, under ``train_4k``'s
  mapping), one train step on a ``mesh`` (data, model) mesh with params
  and moments placed by ``param_specs``/``moment_specs``, ``batch_axes``
  from ``train_batch_axes`` and ``grad_specs`` the param placements, beside
  the same step on plain tensors; with ``kernel`` the attention kernels'
  wrappers are their plain versions and the model runs
  ``kernel_mode="cuda"`` (the DTensor kernel boundary on the CPU).

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


def _train(inp, device, out):
    """The ``train`` job (module docstring): rank 0 keeps each arch's
    gathered new params, loss and grad norm beside the plain step's."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import sharding, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import AdamWState
    from repro_torch.optim.tree import leaves
    from repro_torch.train.steps import init_train_state, make_train_step

    shape = tuple(int(n) for n in inp["mesh"])
    mesh = make_mesh(shape, ("data", "model"), device_type=device)
    cell = ShapeSpec("train_4k", int(inp["seq"]), int(inp["batch"]),
                     "train")
    mode = "auto"
    if int(inp.get("kernel", 0)):
        ops.flash_attention_cuda = ref.flash_attention_ref
        ops.rff_attention_cuda = ref.chunked_linear_attention_ref
        mode = "cuda"
    for arch in [str(a) for a in inp["archs"]]:
        cfg, _ = specs.resolve_cell(get_config(arch).reduced(),
                                    SHAPES["train_4k"])
        baxes = specs.train_batch_axes(cfg, cell, mesh)
        cfg = replace(cfg, activation_batch_axes=baxes)
        gen = torch.Generator().manual_seed(int(inp["seed"]))
        state = init_train_state(gen, cfg, device=device)
        tokens = torch.randint(0, cfg.vocab_size, (cell.global_batch,
                                                   cell.seq_len),
                               generator=gen).to(device)
        micro = int(inp["micro"])
        plain, pm = make_train_step(cfg, num_microbatches=micro,
                                    kernel_mode=mode)(state,
                                                      {"tokens": tokens})
        pspec = sharding.param_specs(cfg, mesh, state["params"])
        mspec = sharding.moment_specs(cfg, mesh, state["params"])
        dstate = {"params": sharding.distribute(state["params"], mesh,
                                                pspec),
                  "opt": AdamWState(
                      m=sharding.distribute(state["opt"].m, mesh, mspec),
                      v=sharding.distribute(state["opt"].v, mesh, mspec),
                      count=state["opt"].count),
                  "step": state["step"]}
        step = make_train_step(cfg, num_microbatches=micro,
                               batch_axes=baxes, grad_specs=pspec,
                               kernel_mode=mode)
        new, metrics = step(dstate, {"tokens": tokens})
        got = [p.full_tensor() for p in leaves(new["params"])]
        kept = [tuple(p.placements) for p in leaves(new["params"])]
        want = [tuple(p.placements) for p in leaves(dstate["params"])]
        out[f"{arch}_layout_kept"] = np.asarray(kept == want)
        out[f"{arch}_sharded_leaves"] = np.asarray(sum(
            any(type(x).__name__ != "Replicate" for x in pl) for pl in want))
        out[f"{arch}_batch_axes"] = np.asarray(baxes)
        for i, (a, b) in enumerate(zip(got, leaves(plain["params"]))):
            out[f"{arch}_got{i}"] = a.float().cpu().numpy()
            out[f"{arch}_want{i}"] = b.float().cpu().numpy()
        grads = [g.float().cpu().numpy() for g in leaves(
            tree_grads(cfg, state["params"], tokens, micro, mode))]
        for i, g in enumerate(grads):
            out[f"{arch}_grad{i}"] = g
        for k in ("loss", "grad_norm", "lr"):
            out[f"{arch}_{k}"] = np.asarray(float(metrics[k].full_tensor()
                                                  if hasattr(metrics[k],
                                                             "full_tensor")
                                                  else metrics[k]))
            out[f"{arch}_plain_{k}"] = np.asarray(float(pm[k]))


def tree_grads(cfg, params, tokens, micro, mode):
    """The plain step's averaged gradients (the AdamW sign rule's
    reference)."""
    from repro_torch.models import lm_loss
    from repro_torch.train.steps import _value_and_grad

    rows = tokens.shape[0] // micro
    total = None
    for i in range(micro):
        _, g = _value_and_grad(
            lambda p, mb: lm_loss(p, cfg, tokens=mb["tokens"],
                                  kernel_mode=mode),
            params, {"tokens": tokens[i * rows:(i + 1) * rows]})
        from repro_torch.optim.tree import tree_map

        total = g if total is None else tree_map(torch.add, total, g)
    from repro_torch.optim.tree import tree_map

    return tree_map(lambda x: x / micro, total)


def _rank(rank: int, world: int, device: str, job: str, inp_path: str,
          out_path: str, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_krls_mesh

        inp = dict(np.load(inp_path, allow_pickle=False))
        out: dict = {}
        if job == "train":
            _train(inp, device, out)
            if rank == 0:
                np.savez(out_path, **out)
            dist.barrier()
            return
        mesh = make_krls_mesh(device_type=device)
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
