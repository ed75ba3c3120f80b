"""Roofline analysis: terms from a per-device cost, and the HLO cost parser.

Counterpart of ``repro/roofline/analysis.py``. :func:`parse_hlo_cost` and
:class:`HloCost` are ``repro``'s, copied verbatim: pure text parsing of XLA
HLO, useful to anyone holding it. The port has no compile; its per-rank
cost comes from a run under a fake process group
(``roofline.counter.count_cost``), into the same :class:`HloCost`.
:class:`HW`'s defaults are the H100's (below), and
:attr:`RooflineTerms.roofline_fraction` uses the ``HW`` its terms were
made with, where ``repro``'s divides by a fresh default ``HW()``.

``repro``'s notes on the parser follow.

``compiled.cost_analysis()`` counts while-loop (lax.scan) bodies exactly
ONCE, which silently undercounts any scanned program (layers, microbatches,
attention KV blocks) — verified empirically in this repo. This module
re-derives costs by walking the partitioned HLO text and scaling each
``while`` body by its ``known_trip_count`` backend config, giving trustworthy
per-device FLOPs / bytes / collective-bytes for the roofline terms.

Hardware model: NVIDIA H100 SXM 80GB (700 W), spec-sheet rates, the ones
PERF.md's kernel bounds use: 989 TFLOP/s dense bf16 per card, 3.35 TB/s
HBM3, and NVLink 4 at 450 GB/s a direction per card (900 GB/s both ways;
NVIDIA's H100 data sheet). ``repro``'s TPU v5e model is
``HW(197e12, 819e9, 50e9)``.

Collective cost model (ring algorithms on n participants):
  all-reduce 2(n-1)/n x bytes; all-gather / reduce-scatter / all-to-all
  (n-1)/n x full bytes; collective-permute 1 x bytes.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Optional

__all__ = ["HloCost", "parse_hlo_cost", "RooflineTerms", "roofline_terms", "HW"]


@dataclasses.dataclass
class HW:
    peak_flops: float = 989e12  # dense bf16 / card
    hbm_bw: float = 3.35e12  # bytes/s
    ici_bw: float = 450e9  # bytes/s a direction, NVLink 4 (the interconnect)


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2,
    "f32": 4, "f64": 8, "c64": 8, "c128": 16, "token": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\(?[^=]*?\)?)\s+([\w\-]+)\("
)
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_COMMENT_RE = re.compile(r"/\*.*?\*/")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _shape_bytes_elems(type_str: str) -> tuple[int, int]:
    """(bytes, elements) for a possibly-tuple HLO type string."""
    total_b = total_e = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        elems = 1
        if dims:
            for d in dims.split(","):
                elems *= int(d)
        total_e += elems
        total_b += elems * _DTYPE_BYTES[dt]
    return total_b, total_e


def _shape_dims(type_str: str) -> list[int]:
    m = _SHAPE_RE.search(type_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0  # ring-adjusted, per device
    collective_breakdown: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    collective_count: int = 0
    unknown_trip_whiles: int = 0
    # optional detail ledger: (op, shape, ring_bytes) -> total bytes after
    # trip scaling. Used by the perf loop to rank collective hotspots.
    details: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    # dot-FLOPs ledger: "dot SHAPE k=K" -> flops after trip scaling.
    flop_details: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    # bytes ledger: "op SHAPE" -> bytes accessed after trip scaling.
    byte_details: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def add(self, other: "HloCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes_accessed += other.bytes_accessed * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.collective_breakdown.items():
            self.collective_breakdown[k] += v * mult
        self.collective_count += int(other.collective_count * mult)
        self.unknown_trip_whiles += other.unknown_trip_whiles
        for k, v in other.details.items():
            self.details[k] += v * mult
        for k, v in other.flop_details.items():
            self.flop_details[k] += v * mult
        for k, v in other.byte_details.items():
            self.byte_details[k] += v * mult

    def top_collectives(self, n: int = 12) -> list[tuple[str, float]]:
        return sorted(self.details.items(), key=lambda kv: -kv[1])[:n]

    def top_flops(self, n: int = 12) -> list[tuple[str, float]]:
        return sorted(self.flop_details.items(), key=lambda kv: -kv[1])[:n]

    def top_bytes(self, n: int = 12) -> list[tuple[str, float]]:
        return sorted(self.byte_details.items(), key=lambda kv: -kv[1])[:n]


_TRANSCENDENTAL_OPS = {
    "cosine", "sine", "exponential", "log", "tanh", "rsqrt", "sqrt", "power",
    "logistic", "expm1", "log1p", "erf",
}
_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota", "reshape",
    "custom-call", "rng-bit-generator", "optimization-barrier", "domain",
}


def _split_computations(text: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur: Optional[str] = None
    lines: list[str] = []
    for line in text.splitlines():
        hdr = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$", line)
        if hdr:
            cur = hdr.group(1)
            if line.startswith("ENTRY"):
                comps["__entry__"] = lines = []
                comps[cur] = lines
            else:
                lines = comps.setdefault(cur, [])
            continue
        if cur is not None:
            if line.startswith("}"):
                cur = None
                continue
            lines.append(line)
    return comps


def _group_size(line: str, total_devices: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return total_devices


def _cost_of_computation(
    name: str,
    comps: dict[str, list[str]],
    cache: dict[str, HloCost],
    total_devices: int,
) -> HloCost:
    if name in cache:
        return cache[name]
    cache[name] = HloCost()  # break cycles defensively
    cost = HloCost()
    symtab: dict[str, str] = {}
    for line in comps.get(name, ()):
        # /*index=N*/ comments inside long tuple types contain '=' and would
        # derail the instruction regex — strip them first.
        if "/*" in line:
            line = _COMMENT_RE.sub("", line)
        m = _INSTR_RE.match(line)
        if not m:
            continue
        out_name, out_type, op = m.group(1), m.group(2).strip(), m.group(3)
        symtab[out_name] = out_type
        out_bytes, out_elems = _shape_bytes_elems(out_type)

        if op in _FREE_OPS and op != "custom-call":
            continue

        if op == "while":
            body = re.search(r"body=%([\w.\-]+)", line)
            trips = 1
            tm = _TRIP_RE.search(line)
            if tm:
                trips = int(tm.group(1))
            else:
                cost.unknown_trip_whiles += 1
            if body:
                sub = _cost_of_computation(body.group(1), comps, cache, total_devices)
                cost.add(sub, trips)
            cond = re.search(r"condition=%([\w.\-]+)", line)
            if cond:
                sub = _cost_of_computation(cond.group(1), comps, cache, total_devices)
                cost.add(sub, trips)
            continue

        if op in ("fusion", "call"):
            callee = re.search(r"(?:calls|to_apply)=%([\w.\-]+)", line)
            if callee:
                sub = _cost_of_computation(callee.group(1), comps, cache, total_devices)
                # fusion: internal flops count, internal bytes do NOT (fused)
                c2 = HloCost(
                    flops=sub.flops,
                    transcendentals=sub.transcendentals,
                    bytes_accessed=0.0,
                    collective_bytes=sub.collective_bytes,
                    collective_breakdown=dict(sub.collective_breakdown),
                    collective_count=sub.collective_count,
                )
                cost.add(c2)
            # fusion I/O bytes: operands + result. In-place update pattern
            # (scan-state dynamic-update-slice fusions): an operand whose
            # type exactly matches an output element is the aliased buffer
            # XLA updates in place — counting it as a full read would charge
            # phantom traffic per loop trip, so it is excluded (the write is
            # still counted via out_bytes once).
            out_elem_types = set(
                f"{d}[{s}]" for d, s in _SHAPE_RE.findall(out_type)
            )
            # kLoop fusions are elementwise-shaped: each operand contributes
            # at most ~out_bytes of real reads (slice/gather fusions read a
            # window of a large buffer — charging the whole buffer per loop
            # trip charged 32x phantom traffic for scan-stacked params).
            # kInput/kOutput (reduce-rooted) fusions read operands fully.
            is_loop_fusion = "kind=kLoop" in line
            ops_bytes = 0
            tail = line.split(f"%{out_name}", 1)[1] if f"%{out_name}" in line else line
            for om in re.finditer(r"%([\w.\-]+)", tail):
                t = symtab.get(om.group(1))
                if not t:
                    continue
                o_types = set(f"{d}[{s}]" for d, s in _SHAPE_RE.findall(t))
                if o_types and o_types <= out_elem_types and len(out_elem_types) > 1:
                    continue  # aliased pass-through buffer (tuple fusions)
                b, _ = _shape_bytes_elems(t)
                if is_loop_fusion:
                    b = min(b, out_bytes)
                ops_bytes += b
            cost.bytes_accessed += out_bytes + ops_bytes
            cost.byte_details[f"fusion {out_type.split('{')[0][:80]}"] += (
                out_bytes + ops_bytes
            )
            continue

        if op == "dynamic-update-slice":
            # in-place update: traffic = the update operand, not the buffer
            ops_list = re.findall(r"%([\w.\-]+)", line.split("(", 1)[1])
            upd_bytes = 0
            if len(ops_list) >= 2:
                t = symtab.get(ops_list[1])
                if t:
                    upd_bytes, _ = _shape_bytes_elems(t)
            cost.bytes_accessed += 2 * (upd_bytes or out_bytes)
            cost.byte_details[f"dus {out_type.split('{')[0][:60]}"] += 2 * (
                upd_bytes or out_bytes
            )
            cost.flops += out_elems
            continue

        if op == "conditional":
            branches = re.findall(r"%([\w.\-]+)", line)
            sub_costs = [
                _cost_of_computation(b, comps, cache, total_devices)
                for b in branches
                if b in comps
            ]
            if sub_costs:
                cost.add(max(sub_costs, key=lambda c: c.flops))
            continue

        if any(op.startswith(c) for c in COLLECTIVES):
            base = next(c for c in COLLECTIVES if op.startswith(c))
            if op.endswith("-done"):
                continue
            n = _group_size(line, total_devices)
            if base == "all-reduce":
                moved = 2.0 * (n - 1) / max(n, 1) * out_bytes
            elif base == "all-gather":
                moved = (n - 1) / max(n, 1) * out_bytes
            elif base == "reduce-scatter":
                moved = (n - 1) * out_bytes  # out is the scattered shard
            elif base == "all-to-all":
                moved = (n - 1) / max(n, 1) * out_bytes
            else:  # collective-permute
                moved = float(out_bytes)
            cost.collective_bytes += moved
            cost.collective_breakdown[base] += moved
            cost.collective_count += 1
            cost.bytes_accessed += 2 * out_bytes
            shps = _SHAPE_RE.findall(out_type)
            label = "+".join(f"{d}[{s}]" for d, s in shps[:4]) or "?"
            if len(shps) > 4:
                label += f"+{len(shps) - 4}more"
            cost.details[f"{base} {label} n={n}"] += moved
            continue

        if op == "dot":
            # FLOPs = 2 * prod(result dims) * prod(contracting sizes of lhs)
            operands = re.findall(r"\(%([\w.\-]+)[,)]", line)
            lhs_m = re.search(r"dot\(%([\w.\-]+)", line)
            lhs_type = symtab.get(lhs_m.group(1), "") if lhs_m else ""
            lhs_dims = _shape_dims(lhs_type)
            cdims_m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            k = 1
            if cdims_m and cdims_m.group(1) and lhs_dims:
                for ci in cdims_m.group(1).split(","):
                    ci = int(ci)
                    if ci < len(lhs_dims):
                        k *= lhs_dims[ci]
            res_elems = 1
            for d in _shape_dims(out_type):
                res_elems *= d
            cost.flops += 2.0 * res_elems * k
            cost.flop_details[f"dot {out_type.split('{')[0]} k={k}"] += (
                2.0 * res_elems * k
            )
            in_bytes = 0
            for o in operands[:2]:
                t = symtab.get(o)
                if t:
                    b, _ = _shape_bytes_elems(t)
                    in_bytes += b
            cost.bytes_accessed += out_bytes + in_bytes
            cost.byte_details[f"dot {out_type.split('{')[0]}"] += out_bytes + in_bytes
            continue

        if op == "convolution":
            # rough: treat like dot over the window
            cost.flops += 2.0 * out_elems
            cost.bytes_accessed += 2 * out_bytes
            continue

        # generic elementwise / reduce / select / copy / dynamic-slice ...
        if op in _TRANSCENDENTAL_OPS:
            cost.transcendentals += out_elems
            cost.flops += out_elems
        elif op in ("reduce", "reduce-window", "sort", "scatter", "gather",
                    "dynamic-slice", "dynamic-update-slice", "pad", "slice",
                    "concatenate", "broadcast", "transpose", "copy", "select",
                    "compare", "convert", "clamp", "map"):
            cost.flops += out_elems
        else:
            cost.flops += out_elems
        cost.bytes_accessed += 2 * out_bytes
        cost.byte_details[f"{op} {out_type.split('{')[0]}"] += 2 * out_bytes

    cache[name] = cost
    return cost


def parse_hlo_cost(hlo_text: str, total_devices: int = 1) -> HloCost:
    """Whole-module per-device cost with while-loops scaled by trip count."""
    comps = _split_computations(hlo_text)
    entry = None
    for line in hlo_text.splitlines():
        m = re.match(r"^ENTRY\s+%([\w.\-]+)", line)
        if m:
            entry = m.group(1)
            break
    if entry is None:
        raise ValueError("no ENTRY computation found")
    cache: dict[str, HloCost] = {}
    # Cost every computation reachable from ENTRY only (fusion bodies are
    # reached via call sites; costing them directly would double count).
    return _cost_of_computation(entry, comps, cache, total_devices)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float = 0.0
    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's compute roof achieved at the modelled
        bound: (useful model FLOPs / bound time) / peak, the peak of the
        ``HW`` the terms were made with."""
        if not self.bound_time_s:
            return 0.0
        return (self.model_flops / self.bound_time_s) / self.hw.peak_flops


def roofline_terms(
    cost: HloCost,
    *,
    chips: int,
    model_flops_total: float = 0.0,
    hw: HW | None = None,
) -> RooflineTerms:
    """Per-device HloCost -> roofline terms (seconds).

    ``cost`` is already per-device (partitioned HLO local shapes), so the
    denominators are per-chip rates; ``model_flops_total`` is the *global*
    useful-work estimate and is divided by ``chips`` here.
    """
    hw = hw or HW()
    return RooflineTerms(
        compute_s=cost.flops / hw.peak_flops,
        memory_s=cost.bytes_accessed / hw.hbm_bw,
        collective_s=cost.collective_bytes / hw.ici_bw,
        flops=cost.flops,
        bytes_accessed=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        model_flops=model_flops_total / max(chips, 1),
        hw=hw,
    )
