"""What the tenant bank's families (``families/klms.py``,
``families/krls.py``) bring to the harness: the mix's fields, the cell's
inputs, the comparison that decides ``correct``, the operations of its
writes and the prefixes of the program's spans.

The inputs (:func:`make_inputs`) are the feature map's W and b and the
generator's pool, made on the device from the seed.

The comparison (:func:`compare`): once the window has closed, the
family's plain reference replays, in float64, the last ``stream_rounds``
rounds of the run for every slot of the bank, with the run's inputs and
its session starts (a slot's reference row starts fresh where its current
session started). It is held against what the timed path produced:

- ``write_gap``: the widest gap between the program's and the reference's
  prior prediction, or prior error, over every live tick of every current
  session, over the RMS of those ticks' targets y;
- ``read_gap``: the same over every read prediction made during a current
  session (cells with queries), of the slots read where a round reads only
  some;
- ``theta_gap`` (and ``pmat_gap`` for KRLS): the worst slot's distance
  between the program's and the reference's state after the last round,
  over the larger of that slot's reference norm and the median slot's;
- ``step_mismatch``: slots whose tick count differs from the reference's
  (live ticks since the session started): exact, limit 0.

The reset's fresh rows are covered by all of them: every current session
starts from one."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from portbench import generator, program_trace
from portbench.harness import Run, bound_s

__all__ = ["FIELDS", "PREFIXES", "Inputs", "add_write_costs", "compare",
           "describe", "make_inputs", "make_map", "traffic"]

FIELDS = tuple(generator.Traffic.__dataclass_fields__)
PREFIXES = program_trace.PREFIXES
traffic = generator.Traffic.from_dict
_MASK64 = (1 << 63) - 1


@dataclass
class Inputs:
    w: torch.Tensor       # (d, D) the feature map's frequencies
    b: torch.Tensor       # (D,) its phases
    pool: generator.Pool  # every round's inputs


def make_map(cfg: dict, seed: int, device) -> tuple:
    """The feature map's W ``(d, D) ~ N(0, I / sigma^2)`` and b ``(D,) ~
    U(0, 2 pi)``, made by the benchmark from the seed, on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _MASK64)
    d, dfeat = cfg["input_dim"], cfg["num_features"]
    w = torch.randn(d, dfeat, generator=gen, device=device) / cfg["sigma"]
    b = torch.rand(dfeat, generator=gen, device=device) * (2.0 * math.pi)
    return w.contiguous(), b.contiguous()


def make_inputs(cfg: dict, traffic: generator.Traffic, seed: int,
                device) -> Inputs:
    w, b = make_map(cfg, seed, device)
    pool = generator.make_pool(traffic, cfg["bank"], cfg["chunk"],
                               cfg["input_dim"], (seed ^ 0x5EED) & _MASK64,
                               device)
    return Inputs(w, b, pool)


def describe(inputs: Inputs) -> dict:
    return generator.describe(inputs.pool)


def add_write_costs(run: Run, cell, pool, first: int, last: int):
    """Operations and bound of rounds ``first..last-1`` into ``run``, where
    round g writes pool block g mod P (the family's counts)."""
    per_block = [cell.counts.write(cell.cfg, pool.live[k], pool.active[k])
                 for k in range(pool.blocks)]
    for g in range(first, last):
        ops, nbytes = per_block[g % pool.blocks]
        run.write_ops += ops
        run.write_bound_s += bound_s(run, ops, nbytes)


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst slot's ``|prog - ref| / max(|ref|, median |ref|)``."""
    diff = (prog.to(ref.dtype) - ref).flatten(1).norm(dim=1)
    norm = ref.flatten(1).norm(dim=1)
    floor = norm.median()
    if floor == 0:
        return math.inf if bool(diff.max() > 0) else 0.0
    return float((diff / torch.maximum(norm, floor)).max())


def compare(cell, inputs: Inputs, results, g_end: int, leaves: dict,
            seed: int, device) -> dict:
    """The numbers compared. ``results(g)`` gives round g's program outputs
    ``(predictions (B, T), errors (B, T), reads (B, Q) or None, slots read
    (B,) bool or None for every slot)``; ``leaves`` the program's state
    after round ``g_end - 1``. The pool holds every input, so the seed and
    the device are not needed again."""
    del seed, device
    pool, w, b = inputs.pool, inputs.w, inputs.b
    sched = pool.schedule
    dev = pool.xs.device
    g0 = max(0, g_end - sched.stream_rounds)
    start = sched.session_start(g_end).to(dev)
    resets = [sched.slots(j).to(dev) for j in range(sched.groups)]
    ref = cell.reference.Bank(cell.cfg, w, b, dtype=torch.float64)
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64, device=dev)
    wgap, rgap, ysq, nlive = zero, zero, zero, zero
    for g in range(g0, g_end):
        grp = sched.reset_group(g)
        if grp is not None:
            ref.reset(resets[grp])
        k = g % pool.blocks
        pred, err = ref.write(pool.xs[k], pool.ys[k], pool.mask[k])
        ppred, perr, pread, read = results(g)
        on = (start <= g)[:, None]
        live = on & (pool.mask[k] > 0)
        for a, r in ((ppred, pred), (perr, err)):
            d = (a.to(dev, f64) - r).abs()
            wgap = torch.maximum(wgap, torch.where(live, d, zero).max())
        ysq = ysq + torch.where(live, pool.ys[k].to(f64) ** 2, zero).sum()
        nlive = nlive + live.sum()
        if pool.read_blocks:
            rq = ref.read(pool.xq[g % pool.read_blocks])
            d = (pread.to(dev, f64) - rq).abs()
            made = on if read is None else on & read.to(dev)[:, None]
            rgap = torch.maximum(rgap, torch.where(made, d, zero).max())
    yrms = float(torch.sqrt(ysq / torch.clamp(nlive, min=1)))
    out = {"write_gap": float(wgap) / yrms if yrms > 0 else math.inf}
    if pool.read_blocks:
        out["read_gap"] = float(rgap) / yrms if yrms > 0 else math.inf
    refl = ref.leaves()
    for name in ("theta", "pmat"):
        if name in refl:
            out[f"{name}_gap"] = _gap(leaves[name], refl[name])
    out["step_mismatch"] = int((leaves["step"].to(dev).long()
                                != refl["step"]).sum())
    return out
