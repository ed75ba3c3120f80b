"""Parity of the port's launch layer with repro's: meshes, sharding rules,
cell specs, and the sharded train step.

The rules are held leaf for leaf by the rows each rank holds: repro's
PartitionSpec on repro's FakeMesh pattern (GSPMD's tiles, an uneven dim
padded) against the port's placements as DTensor cuts them, for all ten
archs at train_4k and long_500k on both production meshes. The sharded
step runs on four gloo CPU ranks (tests/torch_dist_ranks.py, job
``train``).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.placement_types import Shard, _StridedShard

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as jt
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as tt
from repro_torch.optim.tree import leaves
from repro_torch.train.steps import init_train_state, make_train_step

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """repro's mesh-like pattern (tests/test_distributed.py): the rules
    read only ``.shape`` and ``.axis_names``."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = int(np.prod(list(axes.values())))


def _coords(sizes: dict):
    names = tuple(sizes)
    return [dict(zip(names, c))
            for c in itertools.product(*(range(sizes[a]) for a in names))]


@functools.lru_cache(maxsize=None)
def _gspmd_rows(n: int, entry, sizes_items) -> tuple:
    """Each rank's rows [start, stop) of a dim of size n under a
    PartitionSpec entry: the shard index over the entry's axes major to
    minor, tiles of ceil(n / shards) (GSPMD pads the last)."""
    sizes = dict(sizes_items)
    out = []
    for c in _coords(sizes):
        if entry is None:
            out.append((0, n))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        k, total = 0, 1
        for a in axes:
            k, total = k * sizes[a] + c[a], total * sizes[a]
        tile = -(-n // total)
        lo, hi = min(k * tile, n), min((k + 1) * tile, n)
        out.append((lo, hi) if hi > lo else None)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _dtensor_rows(n: int, cuts, sizes_items) -> tuple:
    """Each rank's rows of a dim of size n as DTensor cuts it: ``cuts`` are
    the (mesh dim, split factor or 0 for a plain Shard) that shard this
    dim, applied in mesh order with the placements' own split."""
    sizes = dict(sizes_items)
    names = tuple(sizes)
    out = []
    whole = torch.arange(n)
    for c in _coords(sizes):
        idx = whole
        for k, split in cuts:
            p = _StridedShard(0, split_factor=split) if split else Shard(0)
            idx = p._split_tensor(idx, sizes[names[k]], with_padding=False,
                                  contiguous=False)[0][c[names[k]]]
        if not len(idx):
            out.append(None)
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        assert len(idx) == hi - lo and bool((idx.diff() == 1).all()), (
            n, cuts)
        out.append((lo, hi))
    return tuple(out)


def _hold_rows(shape, jspec, places, sizes, label):
    """Every rank holds the same rows of every dim under both."""
    items = tuple(sizes.items())
    jspec = tuple(jspec) + (None,) * (len(shape) - len(tuple(jspec)))
    for d, n in enumerate(shape):
        cuts = tuple((k, getattr(p, "split_factor", 0))
                     for k, p in enumerate(places)
                     if isinstance(p, (Shard, _StridedShard)) and p.dim == d)
        assert (_gspmd_rows(n, jspec[d], items)
                == _dtensor_rows(n, cuts, items)), (label, d, jspec, places)


def _repro_leaves(tree, specs, stack_key: str, stacked: bool) -> dict:
    """repro's leaves by path (the stacked layer dim dropped): path ->
    (shape, spec)."""
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for (path, leaf), (_, spec) in zip(flat_t, flat_s):
        names = jsh._key_names(path)
        shape, spec = tuple(leaf.shape), tuple(spec)
        if stacked and names and names[0] == stack_key:
            shape, spec = shape[1:], spec[1:]
        out["/".join(names)] = (shape, spec)
    return out


def _port_leaves(tree, specs, stack_key: str, stacked: bool) -> dict:
    out = {}

    def one(names, leaf, places):
        if not isinstance(leaf, torch.Tensor):
            return
        key = names
        if stacked and names and names[0] == stack_key:
            key = names[:1] + names[2:]
        out.setdefault("/".join(key), []).append((tuple(leaf.shape),
                                                  places))

    tsh.tree_map_with_path(one, tree, specs)
    return out


def _hold_tree(jtree, jspecs_tree, ttree, tspecs_tree, stack_key, cfg,
               sizes, label):
    stacked = cfg.scan_layers
    want = _repro_leaves(jtree, jspecs_tree, stack_key, stacked)
    got = _port_leaves(ttree, tspecs_tree, stack_key, stacked)
    if not stacked:  # repro lists the layers under another key
        want = {k.replace("blocks_list", "blocks"): v
                for k, v in want.items()}
    want = {k: v for k, v in want.items() if v[0] or k in got}
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for key, per_layer in got.items():
        jshape, jspec = want[key]
        for shape, places in per_layer:
            assert shape == jshape, (label, key)
            _hold_rows(shape, jspec, places, sizes, f"{label} {key}")


def _port_params(cfg):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return tt.init_params(torch.Generator(), cfg, device="cpu")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_name", ["train_4k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_hold_repro_rows(arch, shape_name, mesh_name):
    """param_specs, moment_specs and decode_state_specs: every leaf's rows
    on every rank are repro's (the cell's resolved config)."""
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    jcfg, _ = jspecs.resolve_cell(jax_get_config(arch), JSHAPES[shape_name])
    cfg, _ = tspecs.resolve_cell(get_config(arch), SHAPES[shape_name])
    jparams = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    params = _port_params(cfg)
    label = f"{arch} {shape_name} {mesh_name}"
    _hold_tree(jparams, jsh.param_specs(jcfg, mesh, jparams), params,
               tsh.param_specs(cfg, mesh, params), "blocks", cfg, sizes,
               label + " params")
    _hold_tree(jparams, jsh.moment_specs(jcfg, mesh, jparams), params,
               tsh.moment_specs(cfg, mesh, params), "blocks", cfg, sizes,
               label + " moments")
    shape = SHAPES[shape_name]
    jstate = jspecs.decode_state_shape(jcfg, JSHAPES[shape_name])
    state = tspecs.decode_state_shape(cfg, shape)
    _hold_tree(jstate, jsh.decode_state_specs(jcfg, mesh, jstate,
                                              shape.global_batch),
               state, tsh.decode_state_specs(cfg, mesh, state,
                                             shape.global_batch),
               "stack", cfg, sizes, label + " decode state")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mla_cache_at_one_sequence_is_model_major(mesh_name):
    """The MLA latent cache at B = 1 is sharded ("model",) + dp, model-major
    on a data-major mesh: the port's _StridedShard placements give each
    rank GSPMD's rows."""
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    jcfg = jax_get_config("deepseek-v2-lite-16b")
    cfg = get_config("deepseek-v2-lite-16b")
    spec = jsh.decode_state_specs(
        jcfg, mesh, jax.eval_shape(lambda: jt.decode_state_init(
            jcfg, 1, 65536)), 1)["stack"].c_kv
    state = tspecs.decode_state_shape(
        cfg, dataclasses.replace(SHAPES["long_500k"], seq_len=65536))
    places = tsh.decode_state_specs(cfg, mesh, state, 1)["stack"][0].c_kv
    assert any(isinstance(p, _StridedShard) for p in places)
    _hold_rows(tuple(state["stack"][0].c_kv.shape), tuple(spec)[1:], places,
               sizes, "c_kv at B = 1")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_match_repro(mesh_name):
    """resolve_cell, train_batch_axes, input_specs, input_shardings,
    batch_specs and dp_size equal repro's for every cell."""
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    for arch, shape_name in itertools.product(ARCH_IDS, SHAPES):
        jcfg, jnote = jspecs.resolve_cell(jax_get_config(arch),
                                          JSHAPES[shape_name])
        cfg, note = tspecs.resolve_cell(get_config(arch), SHAPES[shape_name])
        assert note == jnote
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, shape_name, f.name)
        shape = SHAPES[shape_name]
        assert (tspecs.train_batch_axes(cfg, shape, mesh)
                == jspecs.train_batch_axes(jcfg, JSHAPES[shape_name], mesh))
        jin = jspecs.input_specs(jcfg, JSHAPES[shape_name])
        tin = tspecs.input_specs(cfg, shape)
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jin.items()} == {
            k: (v.shape, str(v.dtype).removeprefix("torch."))
            for k, v in tin.items()}
        if shape.kind in ("train", "prefill"):
            baxes = jspecs.train_batch_axes(jcfg, JSHAPES[shape_name], mesh)
            jbatch = (baxes or None,)
        else:
            jbatch = tuple(jsh.batch_specs(mesh, batch=shape.global_batch,
                                           kind=shape.kind)) or (None,)
        for name, sharding in tspecs.input_shardings(cfg, shape,
                                                     mesh).items():
            assert sharding.placements == tsh.placements(jbatch, mesh), name
        assert tsh.batch_specs(mesh, batch=shape.global_batch,
                               kind=shape.kind) == tsh.placements(
            tuple(jsh.batch_specs(mesh, batch=shape.global_batch,
                                  kind=shape.kind)), mesh)
    assert tspecs.dp_size(mesh) == jspecs.dp_size(mesh)


def _repro_dryrun():
    """repro.launch.dryrun, imported with XLA_FLAGS put back (it asks for
    512 host devices when imported)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def test_model_flops_match_repro():
    from repro_torch.launch.dryrun import model_flops

    jdry = _repro_dryrun()
    for arch, shape_name in itertools.product(ARCH_IDS, SHAPES):
        jcfg, _ = jspecs.resolve_cell(jax_get_config(arch),
                                      JSHAPES[shape_name])
        cfg, _ = tspecs.resolve_cell(get_config(arch), SHAPES[shape_name])
        assert model_flops(cfg, SHAPES[shape_name]) == jdry.model_flops(
            jcfg, JSHAPES[shape_name]), (arch, shape_name)


def test_production_mesh_needs_its_world():
    """make_production_mesh builds on the caller's process group: none
    raises, a world of another size raises; 256 and 512 fake ranks give
    repro's shapes and axis names."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device_type="cpu")
    for world, multi, shape, axes in ((4, False, None, None),
                                      (256, False, (16, 16),
                                       ("data", "model")),
                                      (512, True, (2, 16, 16),
                                       ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            if shape is None:
                with pytest.raises(ValueError, match="ranks"):
                    tmesh.make_production_mesh(device_type="cpu")
                continue
            m = tmesh.make_production_mesh(multi_pod=multi,
                                           device_type="cpu")
            assert tuple(m.shape) == shape and m.mesh_dim_names == axes
            assert tmesh.data_axes(m) == axes[:-1] == tmesh.DP_AXES(m)
            assert tmesh.data_axes(FakeMesh(dict(zip(axes, shape)))) == (
                axes[:-1])
        finally:
            dist.destroy_process_group()
    assert tmesh.MODEL_AXIS == "model"


def test_train_step_constraints_are_no_ops_on_plain_tensors():
    """With plain tensors, batch_axes and grad_specs change no bit of the
    step (and activation_batch_axes none of the forward)."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    mesh = FakeMesh(MESHES["single"])
    a, ma = make_train_step(cfg, num_microbatches=2)(state,
                                                     {"tokens": tokens})
    pinned = dataclasses.replace(cfg, activation_batch_axes=("data",))
    b, mb = make_train_step(
        pinned, num_microbatches=2, batch_axes=("data", "model"),
        grad_specs=tsh.param_specs(cfg, mesh, state["params"]))(
        state, {"tokens": tokens})
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    for k in ma:
        assert torch.equal(ma[k], mb[k])


def _placed(t, mesh, places):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, places, run_check=False)


def test_kernel_boundary_takes_rows_and_raises_on_the_rest():
    """On the kernel route a DTensor reaches the kernel as its local rows
    (a sharded sequence or feature dim, or a pending sum, is made whole
    first; a later input whole where the first splits rows is cut alike);
    rows placed unlike, or DTensors beside plain tensors, raise: nothing
    falls back to the plain version."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Partial, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore

    calls = []

    def kernel(q, k, v, *, causal=True):
        calls.append((type(q).__name__, tuple(q.shape), tuple(k.shape)))
        return ref.flash_attention_ref(q, k, v, causal=causal)

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    saved = ops.flash_attention_cuda
    ops.flash_attention_cuda = kernel
    try:
        mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
        x = torch.randn(4, 8, 16)
        rows = [_placed(x, mesh, (Shard(0),)) for _ in range(3)]
        out = ops.flash_attention(*rows, mode="cuda")
        assert calls[-1] == ("Tensor", (4, 8, 16), (4, 8, 16))
        assert out.placements == (Shard(0),) and out.shape == (8, 8, 16)
        seq = [_placed(x, mesh, (Shard(1),)) for _ in range(3)]
        out = ops.flash_attention(*seq, mode="cuda")
        assert calls[-1][1] == (4, 16, 16)  # the sequence made whole
        feat = [_placed(x, mesh, (Shard(2),)) for _ in range(3)]
        ops.flash_attention(*feat, mode="cuda")
        assert calls[-1][1] == (4, 8, 32)  # the contracted features whole
        ops.flash_attention(*[_placed(x, mesh, (Partial(),))] * 3,
                            mode="cuda")
        assert calls[-1][1] == (4, 8, 16)  # the pending sum taken first
        with pytest.raises(TypeError, match="all DTensors"):
            ops.flash_attention(rows[0], x, rows[2], mode="cuda")
        whole = _placed(torch.randn(8, 8, 16), mesh, (Replicate(),))
        ops.flash_attention(rows[0], whole, rows[2], mode="cuda")
        assert calls[-1] == ("Tensor", (4, 8, 16), (4, 8, 16))  # cut alike
        strided = _placed(x, mesh, (_StridedShard(0, split_factor=2),))
        with pytest.raises(ValueError, match="placed alike"):
            ops.flash_attention(rows[0], strided, rows[2], mode="cuda")
    finally:
        ops.flash_attention_cuda = saved
        dist.destroy_process_group()


def test_sharded_train_step_on_four_gloo_ranks(tmp_path):
    """Reduced qwen2-0.5b (dp) and deepseek-v2-lite-16b (fsdp) each take a
    train step on a (2, 2) mesh of four gloo CPU ranks, params and moments
    placed by param_specs/moment_specs, through the kernel route's DTensor
    boundary (the kernels' wrappers their plain versions): loss and grad
    norm within 1e-5 of the plain step, each new param within 1e-5 where
    its gradient is clear of rounding (|g| > 1e-6 max|g|) and within 2 lr
    elsewhere (AdamW's first step is lr times a sign), and the state keeps
    its placements."""
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    archs = ["qwen2-0.5b", "deepseek-v2-lite-16b"]
    np.savez(inp, mesh=np.array([2, 2]), seq=16, batch=8, micro=2, seed=3,
             archs=np.array(archs), kernel=1)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dist_ranks.py"), "4",
         "cpu", "train", str(inp), str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    res = dict(np.load(out))
    assert int(res["deepseek-v2-lite-16b_sharded_leaves"]) > 0
    for arch in archs:
        assert bool(res[f"{arch}_layout_kept"])
        assert list(res[f"{arch}_batch_axes"]) == ["data", "model"]
        for k in ("loss", "grad_norm"):
            assert abs(float(res[f"{arch}_{k}"])
                       - float(res[f"{arch}_plain_{k}"])) <= 1e-5, (arch, k)
        lr = float(res[f"{arch}_lr"])
        i = 0
        while f"{arch}_got{i}" in res:
            got, want = res[f"{arch}_got{i}"], res[f"{arch}_want{i}"]
            g = np.abs(res[f"{arch}_grad{i}"])
            clear = g > 1e-6 * g.max()
            diff = np.abs(got - want)
            assert diff[clear].max(initial=0.0) <= 1e-5, (arch, i)
            assert diff.max() <= 2 * lr, (arch, i)
            i += 1
        assert i > 20
