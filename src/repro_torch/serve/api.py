"""Serving facade: ``make_server`` and its building blocks, KLMS and KRLS
tiers.

Counterpart of ``repro/serve/api.py`` for ``learner="klms"`` and
``"krls"``: a :class:`Server` wraps the write path (micro-batch queue ->
the family's CUDA chunk kernel), the read path (snapshot-decoupled fused
predict, shared by both families), the tenant lifecycle (evict, then
readmit by replaying the tenant's log) and a metrics registry.
:func:`make_tick`, :func:`make_chunk_step`, :func:`make_queue` and
:func:`run_stream` are the pieces it composes.

Other learners, and the knobs of later slices, raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.bank import (
    evict_tenant,
    klms_bank_chunk_step,
    klms_bank_init,
    klms_bank_run,
    klms_bank_step,
    krls_bank_chunk_step,
    krls_bank_init,
    krls_bank_run,
    krls_bank_step,
    rebuild_tenant,
)
from repro_torch.features.base import FeatureLike, as_trig
from repro_torch.features.base import input_dim as fm_input_dim
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.snapshot import SnapshotServer

__all__ = [
    "LEARNER_FAMILIES",
    "Server",
    "make_server",
    "make_tick",
    "make_chunk_step",
    "make_queue",
    "run_stream",
]

LEARNER_FAMILIES = ("klms", "nklms", "qklms", "krls", "ald")

# Where each unported family lands (ROADMAP.md, "Open items").
_UNPORTED_LEARNERS = {
    "nklms": "ROADMAP §1 item 6",
    "qklms": "ROADMAP §1 item 6",
    "ald": "ROADMAP §1 item 6",
}

# Knobs of make_server that belong to later slices, with their items.
_UNPORTED_KNOBS = {
    "policy": "ROADMAP §1 item 5 (serve/policy.py)",
    "auto_resize": "ROADMAP §1 item 5 (serve/policy.py)",
    "trace": "ROADMAP §1 item 9 (obs/trace.py)",
    "probe": "ROADMAP §1 item 9 (obs/probes.py)",
    "recovery": "ROADMAP §1 item 9 (serve/recovery.py)",
    "wal": "ROADMAP §1 item 9 (serve/recovery.py)",
}

_REBUILD_MODES = ("scan", "blocked", "sequential")

# One defaults table for every family, as in repro; klms reads mu, krls
# reads beta (and lam for a fresh bank).
_HP_DEFAULTS = dict(
    mu=0.5, eps=1e-6, lam=1e-4, beta=0.9995, sigma=1.0, quant_eps=0.1,
    nu=5e-4, capacity=256,
)


def _check_learner(learner: str) -> None:
    if learner not in LEARNER_FAMILIES:
        raise ValueError(
            f"unknown learner {learner!r}; pick from {LEARNER_FAMILIES}"
        )
    if learner in _UNPORTED_LEARNERS:
        raise NotImplementedError(
            f"learner {learner!r} is not ported to repro_torch yet: "
            f"{_UNPORTED_LEARNERS[learner]}"
        )


def _resolve_hp(hp: dict) -> dict:
    unknown = set(hp) - set(_HP_DEFAULTS)
    if unknown:
        raise TypeError(
            f"unknown hyperparameters {sorted(unknown)}; "
            f"known: {sorted(_HP_DEFAULTS)}"
        )
    return {**_HP_DEFAULTS, **hp}


def _rate(learner: str, h: dict):
    """The family's per-tick hyperparameter: KLMS's mu, KRLS's beta."""
    return h["beta"] if learner == "krls" else h["mu"]


def _resolve_input_dim(learner: str, feature_map,
                       input_dim: Optional[int]) -> int:
    """``repro``'s rule: a feature map's input width wins and ``input_dim``
    is then ignored; without a map ``input_dim`` is the width. The ported
    families (klms, krls) need a map all the same; the dictionary
    learners that take ``input_dim`` alone are not ported
    (``_check_learner`` raises for them first)."""
    if feature_map is not None:
        return fm_input_dim(feature_map)
    if input_dim is not None:
        raise ValueError(
            f"learner {learner!r} requires feature_map= (input_dim= alone "
            "serves only the dictionary learners, not ported yet)"
        )
    raise ValueError(f"learner {learner!r} requires feature_map=")


def make_tick(learner: str, feature_map: FeatureLike = None, *,
              mode: str = "auto", input_dim: Optional[int] = None,
              **hp) -> Callable:
    """Lockstep tick ``(state, xs (B, d), ys (B,)) -> (state, StepOut)``
    through the family's fused step kernel. ``input_dim`` follows
    ``repro``'s rule (the map's width wins)."""
    _check_learner(learner)
    _resolve_input_dim(learner, feature_map, input_dim)
    rate = _rate(learner, _resolve_hp(hp))
    tf = as_trig(feature_map)
    bank_step = krls_bank_step if learner == "krls" else klms_bank_step

    def tick(state, xs, ys):
        return bank_step(state, xs, ys, tf, rate, mode=mode)

    return tick


def make_chunk_step(learner: str, feature_map: FeatureLike = None, *,
                    mode: str = "auto", input_dim: Optional[int] = None,
                    **hp) -> Callable:
    """Chunked step ``(state, xs (B, T, d), ys (B, T), mask (B, T)) ->
    (state, StepOut)``: one chunk-kernel launch (the queue's step).
    ``input_dim`` follows ``repro``'s rule (the map's width wins)."""
    _check_learner(learner)
    _resolve_input_dim(learner, feature_map, input_dim)
    rate = _rate(learner, _resolve_hp(hp))
    tf = as_trig(feature_map)
    chunk_step = (krls_bank_chunk_step if learner == "krls"
                  else klms_bank_chunk_step)

    def step(state, xs, ys, mask):
        return chunk_step(state, xs, ys, tf, rate, mask, mode=mode)

    return step


def run_stream(learner: str, feature_map: FeatureLike, xs, ys, *,
               state=None, mode: str = "auto", chunk: Optional[int] = None,
               input_dim: Optional[int] = None, **hp):
    """Serve B lockstep tenant streams ``xs (B, n, d)``, ``ys (B, n)``;
    ``chunk=T`` picks the chunk-kernel schedule. ``input_dim`` follows
    ``repro``'s rule (the map's width wins)."""
    _check_learner(learner)
    _resolve_input_dim(learner, feature_map, input_dim)
    h = _resolve_hp(hp)
    if learner == "krls":
        return krls_bank_run(feature_map, xs, ys, h["lam"], h["beta"],
                             state=state, mode=mode, chunk=chunk)
    return klms_bank_run(feature_map, xs, ys, h["mu"], state=state,
                         mode=mode, chunk=chunk)


def make_queue(learner: str = "klms", feature_map: FeatureLike = None,
               bank: int = 8, *, chunk: int = 16, mode: str = "auto",
               adaptive: bool = False, state=None,
               input_dim: Optional[int] = None, device="cuda",
               **hp) -> MicroBatchQueue:
    """Ready-to-serve micro-batch queue: a fresh bank state on ``device``
    plus the chunk step, coalescing ragged arrivals into masked
    ``(B, T)`` launches. ``input_dim`` follows ``repro``'s rule (the
    map's width wins)."""
    _check_learner(learner)
    _resolve_input_dim(learner, feature_map, input_dim)
    tf = as_trig(feature_map).to(resolve_device(device))
    if state is None and learner == "krls":
        state = krls_bank_init(tf, bank, _resolve_hp(hp)["lam"])
    elif state is None:
        state = klms_bank_init(tf, bank)
    return MicroBatchQueue(
        make_chunk_step(learner, tf, mode=mode, **hp), state,
        tf.input_dim, chunk=chunk, adaptive=adaptive,
    )


class Server:
    """One serving object per bank: write path, read path and metrics.

    Built by :func:`make_server`. ``tenant`` arguments are bank-slot
    indices in ``[0, slots)``. Metrics (``self.metrics``): counters
    ``requests.write`` / ``requests.read``, gauge ``queue.backlog``,
    histograms ``latency.write_us`` / ``latency.read_us`` (host clock),
    lifecycle counters ``evictions`` / ``readmissions`` / ``resets``.
    """

    def __init__(self, inner: SnapshotServer, *, learner: str,
                 feature_map: FeatureLike, hp: dict,
                 metrics: Optional[MetricsRegistry] = None,
                 latency_clock: Callable[[], float] = time.perf_counter):
        self._inner = inner
        self.learner = learner
        self.feature_map = feature_map
        self._hp = hp
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lat = latency_clock

    @property
    def queue(self) -> MicroBatchQueue:
        return self._inner.queue

    @property
    def snapshot(self):
        return self._inner.snapshot

    @property
    def staleness(self) -> int:
        return self._inner.staleness

    @property
    def slots(self) -> int:
        return self._inner.queue.num_tenants

    @property
    def snapshot_server(self) -> SnapshotServer:
        return self._inner

    def submit(self, tenant: int, x, y) -> None:
        """Enqueue one observation for ``tenant`` (a watermark may flush)."""
        t0 = self._lat()
        self.metrics.counter("requests.write").inc()
        self._inner.submit(tenant, x, y)
        self.metrics.set_gauge(
            "queue.backlog", float(sum(self._inner.queue.backlog()))
        )
        self.metrics.histogram("latency.write_us").observe(
            (self._lat() - t0) * 1e6
        )

    def flush(self) -> dict:
        return self._inner.flush()

    def maybe_flush(self) -> dict:
        return self._inner.maybe_flush()

    def drain(self) -> dict:
        return self._inner.drain()

    def predict(self, tenant: int, xs) -> torch.Tensor:
        """Serve queries for one tenant from the frozen read replica:
        ``xs (d,)`` -> scalar, ``(Q, d)`` -> ``(Q,)``."""
        t0 = self._lat()
        self.metrics.counter("requests.read").inc()
        pred = self._inner.predict(tenant, xs)
        self.metrics.histogram("latency.read_us").observe(
            (self._lat() - t0) * 1e6
        )
        return pred

    def predict_block(self, xq) -> torch.Tensor:
        """Serve a ``(B, Q, d)`` query block over the whole bank in one
        launch from the frozen replica -> ``(B, Q)``."""
        t0 = self._lat()
        self.metrics.counter("requests.read").inc()
        pred = self._inner.predict_block(xq)
        self.metrics.histogram("latency.read_us").observe(
            (self._lat() - t0) * 1e6
        )
        return pred

    @property
    def evicted(self) -> frozenset[int]:
        """Tenants whose slots are released."""
        return self._inner.evicted

    def evict(self, tenant: int) -> int:
        """Release ``tenant``'s slot (a fresh row is parked there; its later
        arrivals are only logged). Returns the dropped pending count."""
        self.metrics.counter("evictions").inc()
        return self._inner.evict(tenant)

    def readmit(self, tenant: int) -> int:
        """Re-admit ``tenant``, rebuilding its slot from the replay log with
        the server's ``rebuild_mode``. Returns the ticks replayed."""
        n = self._inner.readmit(tenant)
        self.metrics.counter("readmissions").inc()
        return n

    def reset_tenant(self, tenant: int) -> int:
        """Reset one tenant to a fresh row and forget its replay history.
        Returns the dropped pending count."""
        self.metrics.counter("resets").inc()
        return self._inner.reset_tenant(tenant)


def make_server(
    learner: str = "klms",
    *,
    feature_map: FeatureLike = None,
    bank: int = 8,
    chunk: int = 16,
    mode: str = "auto",
    adaptive: bool = False,
    precision: Optional[str] = None,
    publish_every: int = 1,
    age_watermark: Optional[float] = None,
    size_watermark: Optional[int] = None,
    clock: Callable[[], float] = time.monotonic,
    metrics: Optional[MetricsRegistry] = None,
    state=None,
    input_dim: Optional[int] = None,
    device="cuda",
    log_capacity: Optional[int] = None,
    rebuild_mode: str = "scan",
    **kw,
) -> Server:
    """The serving facade for ``learner="klms"`` and ``"krls"``.

    Args:
      feature_map: a trig feature map, :class:`FeatureMap` or
        :class:`TrigFeatures` (moved to ``device``).
      input_dim: ``repro``'s input width; a feature map's width wins and
        ``input_dim`` is then ignored (the ported families need a map).
      bank: number of bank slots B.
      chunk / mode / adaptive: micro-batch queue knobs (serve/queue.py);
        ``mode`` also drives the read path ("auto", "cuda" or "ref").
      precision / publish_every / age_watermark / size_watermark / clock:
        snapshot-tier knobs (serve/snapshot.py).
      metrics: a shared :class:`MetricsRegistry` (fresh one by default).
      state: initial bank state (fresh zeros by default).
      device: where the state and the map live; ``"cuda"`` by default,
        which raises when there is no CUDA device.
      log_capacity: per-tenant replay-log ring size (serve/snapshot.py);
        None keeps no log, and a readmitted tenant restarts cold.
      rebuild_mode: replay schedule of ``readmit`` (core/scan.py):
        ``"scan"``, ``"blocked"`` or ``"sequential"`` (bit for bit the
        training path); its kernels follow ``mode``.
      **kw: family hyperparameters (``mu`` for klms; ``beta`` and ``lam``
        for krls; the other names of ``repro``'s table are accepted and
        unused). The knobs of later slices
        (``policy``, ``trace``, ``probe``, ``recovery``, ``wal``, ...)
        raise ``NotImplementedError``.
    """
    _check_learner(learner)
    for knob in _UNPORTED_KNOBS:
        if kw.get(knob) not in (None, False):
            raise NotImplementedError(
                f"make_server({knob}=...) is not ported yet: "
                f"{_UNPORTED_KNOBS[knob]}"
            )
        kw.pop(knob, None)
    h = _resolve_hp(kw)
    _resolve_input_dim(learner, feature_map, input_dim)
    tf = as_trig(feature_map).to(resolve_device(device))
    if rebuild_mode not in _REBUILD_MODES:
        raise ValueError(
            f"unknown rebuild_mode {rebuild_mode!r}; pick from {_REBUILD_MODES}"
        )
    queue = make_queue(learner, tf, bank, chunk=chunk, mode=mode,
                       adaptive=adaptive, state=state, device=tf.device,
                       **kw)

    def rebuild_fn(bank_state, slot, xs, ys):
        return rebuild_tenant(bank_state, slot, tf, xs, ys, mu=h["mu"],
                              lam=h["lam"], beta=h["beta"],
                              mode=rebuild_mode, kernel_mode=mode)

    def evict_fn(bank_state, slot):
        return evict_tenant(bank_state, slot, lam=h["lam"])

    inner = SnapshotServer(
        queue, tf, publish_every, mode=mode, precision=precision,
        age_watermark=age_watermark, size_watermark=size_watermark,
        clock=clock, log_capacity=log_capacity, evict_fn=evict_fn,
        rebuild_fn=rebuild_fn,
    )
    return Server(inner, learner=learner, feature_map=tf, hp=h,
                  metrics=metrics)
