"""Dry-run of every (arch x input-shape x mesh) cell on a fake process group.

Counterpart of ``repro/launch/dryrun.py``, which forces 512 host devices,
lowers and compiles each cell. The port has no compile. Each cell here
runs the port's own step once, at full width, on a ``DeviceMesh`` over a
fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: this process is rank 0,
and collectives move nothing) with every tensor a fake tensor
(``FakeTensorMode``: nothing is allocated). Params, optimizer state,
decode state and inputs are DTensors placed by ``launch.sharding``'s rules.
The attention kernels run as shape-only stand-ins that count the kernel's
FLOPs and bytes (a CUDA kernel cannot run on fake tensors); everything
else is the port's own code on the local shards.

For each cell this shows, without any GPU:

* that the placements are coherent: every op of the step has a DTensor
  sharding rule for them (a cell whose op has none is reported as failed,
  with the op's name; it is never run unsharded instead);
* each rank's bytes: arguments, outputs and the peak of the run
  (``roofline.counter.CostCounter``);
* the roofline terms (FLOPs, bytes and collective bytes per rank) against
  :class:`~repro_torch.roofline.analysis.HW`.

It is not a compile: the bytes are eager PyTorch's, op by op, and the
numbers a fake run computes are garbage (only shapes, counts and bytes are
read from it).

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (
    distribute,
    moment_specs,
    param_specs,
)
from repro_torch.models import transformer
from repro_torch.optim.optimizers import AdamWState
from repro_torch.optim.tree import leaves
from repro_torch.roofline import HW, roofline_terms
from repro_torch.roofline.counter import CostCounter, tensor_bytes
from repro_torch.train import steps as steps_mod

__all__ = ["run_cell", "model_flops", "main"]

DEFAULT_OUT = os.path.join("build", "dryrun")


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful-work estimate: 6*N_active*D (train) / 2*N_active*D (inference),
    N = active matmul params (embedding lookup excluded unless tied)."""
    n = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model  # lookup table is not matmul work
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# The attention kernels as shape-only stand-ins
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _kernel_stand_ins(counter: CostCounter):
    """While active, ``ops``' three attention kernel wrappers (9, 10, 11)
    return empty outputs of the kernel's shapes and add the kernel's work
    to ``counter``: its FLOPs (the causal half of the score and output
    products for flash; the chunked state walk for linear attention; the
    featurize and state update for the decode block) and its bytes (inputs
    read once, outputs written once)."""
    def add(name, flops, inputs, outputs):
        counter.cost.flops += flops
        counter.cost.flop_details[name] += flops
        moved = sum(tensor_bytes(t) for t in (*inputs, *outputs)
                    if t is not None)
        counter.cost.bytes_accessed += moved
        counter.cost.byte_details[name] += moved

    def flash(q, k, v, *, causal=True):
        bh, s, dh = q.shape
        out = torch.empty(bh, s, v.shape[-1], dtype=q.dtype, device=q.device)
        frac = 0.5 if causal else 1.0
        add("kernel flash_attention",
            2.0 * bh * s * s * (dh + v.shape[-1]) * frac, (q, k, v), (out,))
        return out

    def linear(phi_q, phi_k, v, *, chunk=256, normalize=True, eps=1e-6):
        bh, s, d = phi_q.shape
        dv = v.shape[-1]
        c = min(64, s)
        out = torch.empty(bh, s, dv, dtype=v.dtype, device=v.device)
        add("kernel rff_linear_attention",
            2.0 * bh * s * (2 * d * (dv + 1) + c * (d + dv + 1)),
            (phi_q, phi_k, v), (out,))
        return out

    def decode_block(s_state, z_state, q, k, v, w, b, s=None, **kw):
        bh, t, dh = q.shape
        d, dv = w.shape[-1], v.shape[-1]
        out = torch.empty(bh, t, dv, dtype=torch.float32, device=q.device)
        s_new = torch.empty_like(s_state, dtype=torch.float32)
        z_new = torch.empty_like(z_state, dtype=torch.float32)
        add("kernel rff_decode_block",
            2.0 * bh * t * (2 * dh * d + 2 * d * (dv + 1)),
            (s_state, z_state, q, k, v, w, b, s), (out, s_new, z_new))
        return out, s_new, z_new

    names = {"flash_attention_cuda": flash, "rff_attention_cuda": linear,
             "rff_attention_decode_block_cuda": decode_block}
    saved = {n: getattr(ops, n) for n in names}
    for n, fn in names.items():
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _strided_offsets_on_real_tensors():
    """DTensor computes a ``_StridedShard``'s row indices with torch ops and
    reads them back (``.tolist()``), which fake tensors cannot do; while
    active, that computation runs outside ``FakeTensorMode`` (the indices
    are small and the same on every rank)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    name = "local_shard_size_and_offset"
    original = _StridedShard.__dict__.get(name)
    if original is None:
        yield
        return

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return original(self, *args, **kwargs)

    setattr(_StridedShard, name, real)
    try:
        yield
    finally:
        setattr(_StridedShard, name, original)


@contextlib.contextmanager
def _fake_group(size: int):
    """A fake process group of ``size`` ranks (this process rank 0) unless
    one of that size is already initialized; destroyed at exit if made
    here."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"initialized; this cell needs {size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place_batch(cfg, shape, mesh):
    shardings = specs_mod.input_shardings(cfg, shape, mesh)
    batch = {}
    for name, spec in specs_mod.input_specs(cfg, shape).items():
        t = torch.zeros(spec.shape, dtype=spec.dtype)
        batch[name] = distribute(t, mesh, shardings[name])
    return batch


def _bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _run_fake(cfg, shape, mesh, record, microbatch_override):
    """The cell's step once on fake DTensors: (argument bytes, output
    bytes, its CostCounter)."""
    gen = torch.Generator()
    if shape.kind == "train":
        baxes = specs_mod.train_batch_axes(cfg, shape, mesh)
        bshards = 1
        for a in baxes:
            bshards *= mesh.shape[mesh.mesh_dim_names.index(a)]
        num_micro = (microbatch_override or cfg.train_microbatches
                     or max(1, shape.global_batch // bshards))
        record["num_microbatches"] = num_micro
        cfg = dataclasses.replace(cfg,
                                  activation_batch_axes=tuple(baxes))
        state = steps_mod.init_train_state(gen, cfg, device="cpu")
        pspec = param_specs(cfg, mesh, state["params"])
        mspec = moment_specs(cfg, mesh, state["params"])
        args = {"params": distribute(state["params"], mesh, pspec),
                "opt": AdamWState(
                    m=distribute(state["opt"].m, mesh, mspec),
                    v=distribute(state["opt"].v, mesh, mspec),
                    count=state["opt"].count),
                "step": state["step"]}
        del state
        batch = _place_batch(cfg, shape, mesh)
        step = steps_mod.make_train_step(
            cfg, num_microbatches=num_micro, batch_axes=baxes or None,
            grad_specs=pspec, kernel_mode="cuda")

        def run():
            return step(args, batch)
        arg_bytes = _bytes(args) + _bytes(batch)
    else:
        params = transformer.init_params(gen, cfg, device="cpu")
        params = distribute(params, mesh,
                            param_specs(cfg, mesh, params))
        batch = _place_batch(cfg, shape, mesh)
        if shape.kind == "prefill":
            step = steps_mod.make_prefill_step(cfg, kernel_mode="cuda")

            def run():
                return step(params, batch)
            arg_bytes = _bytes(params) + _bytes(batch)
        else:
            state = specs_mod.decode_state_shape(cfg, shape)
            state = distribute(state, mesh, specs_mod.decode_state_specs(
                cfg, mesh, state, shape.global_batch))
            step = steps_mod.make_decode_step(cfg, kernel_mode="cuda")

            def run():
                return step(params, state, batch)
            arg_bytes = _bytes(params) + _bytes(state) + _bytes(batch)
    counter = CostCounter()
    with _kernel_stand_ins(counter), counter:
        out = run()
    out_bytes = _bytes(out)
    del out
    return arg_bytes, out_bytes, counter


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatch_override: Optional[int] = None,
             want_hlo: bool = False, hw: Optional[HW] = None,
             reduced: bool = False) -> dict:
    """Run one cell under a fake process group; returns the result record
    (``repro``'s keys: ``memory``, ``cost``, ``roofline``; ``run_s`` where
    ``repro`` has ``lower_s`` and ``compile_s``).

    ``hw``: the roofline's hardware (default ``HW()``, the H100's).
    ``reduced``: the arch's ``reduced()`` config (a quick CPU check of the
    placements; the production mesh stays). ``want_hlo`` is ``repro``'s
    keyword; there is no HLO text here, and it must be False. An op with
    no sharding rule for the cell's placements raises."""
    if want_hlo:
        raise ValueError("the port's dry-run runs the step; it has no HLO")
    base_cfg = get_config(arch)
    if reduced:
        base_cfg = base_cfg.reduced()
    shape = SHAPES[shape_name]
    cfg, policy_note = specs_mod.resolve_cell(base_cfg, shape)
    hw = hw or HW()
    chips = 512 if multi_pod else 256
    record = {"arch": arch, "shape": shape_name, "policy": policy_note,
              "kind": shape.kind, "reduced": reduced}
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with _fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        record.update(mesh="x".join(str(n) for n in mesh.shape),
                      axes=list(mesh.mesh_dim_names), chips=mesh.size())
        with FakeTensorMode(), _strided_offsets_on_real_tensors():
            arg_bytes, out_bytes, counter = _run_fake(
                cfg, shape, mesh, record, microbatch_override)
    record["run_s"] = round(time.time() - t0, 2)
    cost = counter.cost
    record["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": counter.peak_bytes,
        "peak_bytes": arg_bytes + counter.peak_bytes,
        "generated_code_bytes": None,
    }
    mf = model_flops(cfg, shape)
    terms = roofline_terms(cost, chips=chips, model_flops_total=mf, hw=hw)
    record["cost"] = {
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes_accessed,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_breakdown": dict(cost.collective_breakdown),
        "collective_count": cost.collective_count,
        "unknown_trip_whiles": cost.unknown_trip_whiles,
        "transcendentals": cost.transcendentals,
        "ops": counter.ops,
    }
    record["roofline"] = {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "bound_time_s": terms.bound_time_s,
        "model_flops_total": mf,
        "useful_flops_frac": terms.useful_flops_frac,
        "roofline_fraction": terms.roofline_fraction,
        "hw": dataclasses.asdict(hw),
    }
    return record


def failed_op(exc: BaseException) -> str:
    """The op a failed cell stopped at, from DTensor's error (``aten.x``),
    else the error's first line."""
    import re

    text = str(exc)
    m = re.search(r"(aten\.[\w.]+|c10d[\w.]*)", text)
    return m.group(1) if m else (text.splitlines() or [repr(exc)])[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=tuple(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() config (a quick check)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)

    os.makedirs(args.out, exist_ok=True)
    failures = {}
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (cached)")
                    continue
                print(f"[run] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape_name, multi_pod=mp,
                                   reduced=args.reduced)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    r, m = rec["roofline"], rec["memory"]
                    print(
                        f"  ok: run={rec['run_s']}s dominant={r['dominant']}"
                        f" compute={r['compute_s']:.3e}s"
                        f" memory={r['memory_s']:.3e}s"
                        f" collective={r['collective_s']:.3e}s"
                        f" useful={r['useful_flops_frac']:.2f}"
                        f" peak={m['peak_bytes'] / 2 ** 30:.2f}GiB",
                        flush=True)
                except Exception as exc:  # a cell that fails is reported
                    failures[tag] = failed_op(exc)
                    print(f"  FAILED {tag}: {failures[tag]}\n"
                          f"{traceback.format_exc()}", flush=True)
    if failures:
        print(json.dumps({"failed": failures}))
        raise SystemExit(f"{len(failures)} cells failed")


if __name__ == "__main__":
    main()
