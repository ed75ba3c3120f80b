"""Parity of the port's roofline with repro's, the per-rank cost counter,
and the fake-group dry-run at reduced width."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.roofline import analysis as janalysis
from repro_torch.launch import dryrun
from repro_torch.roofline import HW, CostCounter, analysis

_HAND_HLO = """HloModule hand, entry_computation_layout={(f32[8,16]{1,0})->f32[8,16]{1,0}}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%fused (p: f32[8,16]) -> f32[8,16] {
  %p = f32[8,16]{1,0} parameter(0)
  ROOT %e = f32[8,16]{1,0} exponential(f32[8,16]{1,0} %p)
}

ENTRY %main (x: f32[8,16]) -> f32[8,16] {
  %x = f32[8,16]{1,0} parameter(0)
  %f = f32[8,16]{1,0} fusion(f32[8,16]{1,0} %x), kind=kLoop, calls=%fused
  %r = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %f), replica_groups=[2,4]<=[8], to_apply=%add
  %g = f32[32,16]{1,0} all-gather(f32[8,16]{1,0} %r), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %t = f32[8,16]{1,0} tanh(f32[8,16]{1,0} %r)
}
"""


def _compiled_hlo(case: str) -> str:
    x = jnp.ones((64, 128), jnp.float32)
    w = jnp.ones((6, 128, 128), jnp.float32)
    if case == "matmul":
        def f(x, w):
            return jnp.tanh(x @ w[0]).sum()
    else:  # a scanned layer stack: its while loop's trip count scales
        def f(x, w):
            def body(h, wl):
                return jnp.tanh(h @ wl), None
            return jax.lax.scan(body, x, w)[0].sum()
    return jax.jit(f).lower(x, w).compile().as_text()


@pytest.mark.parametrize("case", ["matmul", "scan", "hand"])
def test_parse_hlo_cost_equals_repro(case):
    """The copied parser gives repro's HloCost bit for bit, on HLO that JAX
    compiles here (a scanned stack among them) and on hand-written HLO with
    collectives and a fusion."""
    text = _HAND_HLO if case == "hand" else _compiled_hlo(case)
    for devices in (1, 8):
        got = dataclasses.asdict(analysis.parse_hlo_cost(text, devices))
        want = dataclasses.asdict(janalysis.parse_hlo_cost(text, devices))
        assert got == want
    if case == "scan":
        assert got["flops"] >= 6 * 2 * 64 * 128 * 128
        assert got["unknown_trip_whiles"] == 0
    if case == "hand":
        assert got["collective_count"] == 2


def test_roofline_terms_equal_repro_under_its_hw():
    """At repro's TPU rates every term and property is repro's; the port's
    default HW is the H100's, and roofline_fraction divides by the HW the
    terms were made with (repro's by a fresh default HW())."""
    cost = janalysis.parse_hlo_cost(_compiled_hlo("scan"))
    tpu = HW(197e12, 819e9, 50e9)
    got = analysis.roofline_terms(cost, chips=4, model_flops_total=3e9,
                                  hw=tpu)
    want = janalysis.roofline_terms(cost, chips=4, model_flops_total=3e9)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name)
    for prop in ("dominant", "bound_time_s", "useful_flops_frac",
                 "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop)
    assert (HW().peak_flops, HW().hbm_bw, HW().ici_bw) == (989e12, 3.35e12,
                                                           450e9)
    h100 = analysis.roofline_terms(cost, chips=4, model_flops_total=3e9)
    assert h100.roofline_fraction == pytest.approx(
        h100.model_flops / h100.bound_time_s / 989e12, rel=1e-12)
    assert h100.roofline_fraction != janalysis.roofline_terms(
        cost, chips=4, model_flops_total=3e9,
        hw=janalysis.HW(989e12, 3.35e12, 450e9)).roofline_fraction


def test_cost_counter_counts_local_work_and_ring_bytes():
    """On a fake group of 4 ranks: a row-sharded matmul counts each rank's
    quarter of the FLOPs (not the global shape DTensor propagates), and
    gathering its (256, 32) f32 output moves (n-1)/n of 32 KiB."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
        with FakeTensorMode():
            a = DTensor.from_local(torch.zeros(64, 16), mesh, (Shard(0),),
                                   run_check=False)
            w = DTensor.from_local(torch.zeros(16, 32), mesh, (Replicate(),),
                                   run_check=False)
            with CostCounter() as cc:
                y = a @ w
                full = y.redistribute(mesh, (Replicate(),))
        assert full.to_local().shape == (256, 32)
        assert cc.cost.flops == 2 * 64 * 16 * 32
        assert cc.cost.collective_count == 1
        assert cc.cost.collective_bytes == 3 / 4 * 256 * 32 * 4
        assert dict(cc.cost.collective_breakdown) == {
            "all-gather": 3 / 4 * 256 * 32 * 4}
        assert cc.peak_bytes >= (64 + 256) * 32 * 4
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_dryrun_cell_runs_at_reduced_width(shape_name):
    """run_cell finishes a cell of each shape kind (reduced qwen2-0.5b on
    the single-pod mesh of 256 fake ranks) with repro's record keys."""
    rec = dryrun.run_cell("qwen2-0.5b", shape_name, reduced=True)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert set(rec) >= {"memory", "cost", "roofline", "run_s", "policy"}
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["cost"]["bytes_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["hw"] == dataclasses.asdict(HW())
    if shape_name == "train_4k":
        assert rec["num_microbatches"] == 1
        assert rec["cost"]["collective_count"] > 0
    assert not dist.is_initialized()
    json.dumps(rec)


def test_dryrun_reports_a_failed_cell(tmp_path, capsys):
    """A cell whose op has no DTensor rule for its placements (reduced
    deepseek's 4 heads over the 16-way model axis: an uneven flatten) is
    reported as failed with what stopped it, never run unsharded, and main
    exits with an error."""
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape",
                     "decode_32k", "--reduced", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "FAILED deepseek-v2-lite-16b__decode_32k__single" in out
    failed = json.loads(out.strip().splitlines()[-1])["failed"]
    assert list(failed) == ["deepseek-v2-lite-16b__decode_32k__single"]
    assert not list(tmp_path.glob("*.json"))
    assert not dist.is_initialized()
