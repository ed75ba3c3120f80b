"""Per-rank cost of a run, counted op by op: the port's ``parse_hlo_cost``.

``repro`` compiles each cell for 512 forced host devices and walks the
partitioned HLO. The port has no compile. :class:`CostCounter` instead
watches a run of the step, normally under a fake process group
(``torch.testing._internal.distributed.fake_pg``) and ``FakeTensorMode``,
where nothing is allocated and no collective moves data, and counts what
each rank's local ops would do. It is not a compile: nothing is fused or
scheduled, so the bytes are eager PyTorch's traffic (each op reads its
inputs and writes its outputs), and an op with no DTensor sharding rule
raises where GSPMD would have found a layout.

What it counts into an :class:`~repro_torch.roofline.analysis.HloCost`,
per rank:

* FLOPs of the matrix products, from ``torch.utils.flop_counter``'s
  formulas on the local shapes (DTensor hands each rank's op its local
  shards; the global-shape calls DTensor makes to propagate shapes are not
  counted). Elementwise ops add no FLOPs; the transcendentals
  (exp, log, cos, ...) count their output elements, as ``repro``'s parser
  counts them;
* bytes: every op that is not a view reads its tensor inputs and writes
  its outputs, at their local sizes;
* collectives: each ``_c10d_functional`` op (what DTensor's redistributions
  issue) with the ring model of ``roofline.analysis``: all-reduce
  2(n-1)/n x bytes, all-gather and all-to-all (n-1)/n x the full bytes,
  reduce-scatter (n-1) x the shard's bytes, other ops 1 x bytes. On a CPU
  mesh DTensor issues an all-to-all as an all-gather and a chunk.

It also tracks live memory: the bytes of every storage an op allocated
while its tensors live, whose peak (plus the arguments' bytes, which the
caller knows) is the rank's peak.
"""
from __future__ import annotations

import threading
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.analysis import HloCost

__all__ = ["CostCounter", "tensor_bytes"]

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "cos", "sin", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow", "erf", "silu", "gelu", "softplus",
}
_propagating = threading.local()


def tensor_bytes(t) -> int:
    """Bytes of a tensor's (local) elements."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class CostCounter(TorchDispatchMode):
    """A dispatch mode that counts a run's per-rank cost (module
    docstring). Enter it inside ``FakeTensorMode`` and around the step::

        with CostCounter() as cc:
            step(state, batch)
        cc.cost, cc.peak_bytes
    """

    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self._flops = FlopCounterMode(display=False)
        self._live: dict = {}  # storage key -> [bytes, live tensors]
        self._saved = None

    # DTensor runs each op once on global-shape fake tensors to propagate
    # shapes; those calls are not a rank's work.
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        original = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *args, **kwargs):
            _propagating.on = True
            try:
                return original(prop, *args, **kwargs)
            finally:
                _propagating.on = False

        self._saved = (ShardingPropagator, original)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, original = self._saved
        cls._propagate_tensor_meta_non_cached = original
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_propagating, "on", False):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor hands us its local ops
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "_c10d_functional":
            self._collective(func, args, out)
            return out
        is_view = any(r.alias_info is not None for r in func._schema.returns)
        if not is_view:
            self._count(func, args, kwargs, out)
        self._track(func, out, is_view)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        before = self._flops.get_total_flops()
        self._flops._count_flops(packet, out, args, kwargs)
        flops = self._flops.get_total_flops() - before
        name = packet.__name__.rstrip("_")
        outs = list(_tensors(out))
        out_elems = sum(t.numel() for t in outs)
        if name in _TRANSCENDENTAL:
            self.cost.transcendentals += out_elems
            flops += out_elems
        self.cost.flops += flops
        if flops:
            shape = tuple(outs[0].shape) if outs else ()
            self.cost.flop_details[f"{name} {shape}"] += flops
        moved = sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
        moved += sum(tensor_bytes(t) for t in outs)
        self.cost.bytes_accessed += moved
        self.cost.byte_details[name] += moved

    def _collective(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        if name.startswith("wait"):
            return
        data = args[0]
        nbytes = sum(tensor_bytes(t) for t in _tensors(data))
        out_bytes = sum(tensor_bytes(t) for t in _tensors(out))
        n = _group_size(args[-1])
        if name.startswith("all_reduce"):
            base, moved = "all-reduce", 2.0 * (n - 1) / max(n, 1) * out_bytes
        elif name.startswith("all_gather"):
            base, moved = "all-gather", (n - 1) / max(n, 1) * out_bytes
        elif name.startswith("reduce_scatter"):
            base, moved = "reduce-scatter", float((n - 1) * out_bytes)
        elif name.startswith("all_to_all"):
            base, moved = "all-to-all", (n - 1) / max(n, 1) * out_bytes
        else:
            base, moved = name, float(out_bytes)
        self.cost.collective_bytes += moved
        self.cost.collective_breakdown[base] += moved
        self.cost.collective_count += 1
        self.cost.bytes_accessed += nbytes + out_bytes
        self.cost.details[f"{base} {tuple(data.shape)} n={n}"] += moved
        self._track(func, out, False)

    def _track(self, func, out, is_view: bool) -> None:
        """Live bytes: a storage an op allocated counts from then until the
        last tensor on it that the mode saw dies."""
        for t in _tensors(out):
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            entry = self._live.get(key)
            if entry is None:
                if is_view:
                    continue  # a view of storage the run did not allocate
                entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
                self.live_bytes += entry[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

