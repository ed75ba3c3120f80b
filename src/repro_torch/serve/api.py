"""Serving facade: ``make_server`` and its building blocks, for every
learner family.

Counterpart of ``repro/serve/api.py``: a :class:`Server` wraps the write
path (micro-batch queue -> the family's chunk step), the read path
(snapshot-decoupled predict), the tenant lifecycle (evict, then readmit by
replaying the tenant's log) and a metrics registry. :func:`build_learner`,
:func:`make_tick`, :func:`make_chunk_step`, :func:`make_queue`,
:func:`run_stream` and :func:`reset_slots` are the pieces it composes.

Families: ``"klms"`` and ``"krls"`` write through their CUDA chunk
kernels; ``"nklms"`` writes through the generic masked chunk loop (no
fused kernel takes the normalized update, as in ``repro``) and reads and
readmits through the KLMS read and replay kernels; ``"qklms"`` and
``"ald"`` are the growing-dictionary baselines, driven through the same
queue and snapshot machinery by the generic chunk loop over their batched
``OnlineLearner`` step, with dictionary predicts from the frozen replica
and sequential replays. ``repro`` has no kernel for these two families, so
their path is plain PyTorch on the card.

The knobs of later slices raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.bank import (
    bank_init,
    bank_run,
    evict_tenant,
    klms_bank_chunk_step,
    klms_bank_init,
    klms_bank_run,
    klms_bank_step,
    krls_bank_chunk_step,
    krls_bank_init,
    krls_bank_run,
    krls_bank_step,
    per_query,
    rebuild_tenant,
    set_tenant_row,
    tenant_row,
)
from repro_torch.core.klms import StepOut
from repro_torch.core.krls import RLSState
from repro_torch.core.learner import (
    OnlineLearner,
    ald_krls_learner,
    klms_learner,
    krls_learner,
    nklms_learner,
    qklms_learner,
)
from repro_torch.features.base import FeatureLike, as_trig
from repro_torch.features.base import input_dim as fm_input_dim
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.snapshot import SnapshotServer

__all__ = [
    "LEARNER_FAMILIES",
    "Server",
    "build_learner",
    "make_server",
    "make_tick",
    "make_chunk_step",
    "make_queue",
    "reset_slots",
    "run_stream",
]

LEARNER_FAMILIES = ("klms", "nklms", "qklms", "krls", "ald")

# Families whose per-tenant state is a (D,) theta row sharing one feature
# map: they ride the fused read path; the rest carry dictionaries.
_THETA_FAMILIES = frozenset({"klms", "nklms", "krls"})

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

# One defaults table for every family, as in repro; families read only
# their own knobs.
_HP_DEFAULTS = dict(
    mu=0.5,        # klms / nklms / qklms step size
    eps=1e-6,      # nklms normalizer
    lam=1e-4,      # krls init regularizer (P_0 = I / lam)
    beta=0.9995,   # krls forgetting factor
    sigma=1.0,     # qklms / ald kernel bandwidth
    quant_eps=0.1,  # qklms quantization size
    nu=5e-4,       # ald novelty threshold
    capacity=256,  # qklms / ald dictionary capacity
)


def _check_learner(learner: str) -> None:
    if learner not in LEARNER_FAMILIES:
        raise ValueError(
            f"unknown learner {learner!r}; pick from {LEARNER_FAMILIES}"
        )


def _resolve_hp(hp: dict) -> dict:
    unknown = set(hp) - set(_HP_DEFAULTS)
    if unknown:
        raise TypeError(
            f"unknown hyperparameters {sorted(unknown)}; "
            f"known: {sorted(_HP_DEFAULTS)}"
        )
    return {**_HP_DEFAULTS, **hp}


def _resolve_input_dim(learner: str, feature_map,
                       input_dim: Optional[int]) -> int:
    """``repro``'s rule: a feature map's input width wins and
    ``input_dim`` is then ignored; without a map ``input_dim`` is the
    width (which serves the dictionary learners; the RFF families still
    need a map, :func:`build_learner`)."""
    if feature_map is not None:
        return fm_input_dim(feature_map)
    if input_dim is not None:
        return input_dim
    raise ValueError(f"learner {learner!r} needs feature_map= or input_dim=")


def build_learner(learner: str, feature_map: Optional[FeatureLike] = None,
                  input_dim: Optional[int] = None, device="cuda",
                  **hp) -> OnlineLearner:
    """The :class:`OnlineLearner` of one family (the generic chunk loop's
    step, the dictionary predicts and the sequential replays). The RFF
    families live on their map's device; the dictionary learners on
    ``device``."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner in _THETA_FAMILIES and feature_map is None:
        raise ValueError(f"learner {learner!r} requires feature_map=")
    if learner == "klms":
        return klms_learner(feature_map, h["mu"])
    if learner == "nklms":
        return nklms_learner(feature_map, h["mu"], h["eps"])
    if learner == "krls":
        return krls_learner(feature_map, lam=h["lam"], beta=h["beta"])
    d = _resolve_input_dim(learner, feature_map, input_dim)
    dev = resolve_device(device)
    if learner == "qklms":
        return qklms_learner(d, h["sigma"], h["mu"], h["quant_eps"],
                             capacity=h["capacity"], device=dev)
    return ald_krls_learner(d, h["sigma"], nu=h["nu"],
                            capacity=h["capacity"], device=dev)


def _fused_map(learner: str, feature_map, input_dim):
    """The trig map of a fused family (klms, krls), checked as ``repro``
    checks it; ``input_dim`` follows the width rule."""
    if feature_map is None:
        raise ValueError(f"learner {learner!r} requires feature_map=")
    _resolve_input_dim(learner, feature_map, input_dim)
    return as_trig(feature_map)


def make_tick(learner: str, feature_map: FeatureLike = None, *,
              mode: str = "auto", input_dim: Optional[int] = None,
              device="cuda", **hp) -> Callable:
    """Lockstep tick ``(state, xs (B, d), ys (B,)) -> (state, StepOut)``:
    klms and krls through their fused step kernels, the other families
    through their batched ``OnlineLearner`` step (``device`` places the
    dictionary learners)."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner in ("klms", "krls"):
        tf = _fused_map(learner, feature_map, input_dim)
        bank_step = krls_bank_step if learner == "krls" else klms_bank_step
        rate = h["beta"] if learner == "krls" else h["mu"]

        def tick(state, xs, ys):
            return bank_step(state, xs, ys, tf, rate, mode=mode)

        return tick
    lrn = build_learner(learner, feature_map, input_dim, device, **hp)
    return lrn.step_fn


def _gate_leaf(mask_b: torch.Tensor, new, old):
    m = mask_b.reshape(mask_b.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def _generic_chunk_server(lrn: OnlineLearner) -> Callable:
    """Masked chunk step over a learner's batched step: ``(state, xs (B,
    T, d), ys (B, T), mask (B, T)) -> (state, StepOut (B, T))``, a loop
    over the T ticks. A masked tick leaves every state leaf untouched,
    integer leaves included (a per-leaf select), so ragged chunks stay
    exact for the dictionary learners too."""

    def step(state, xs, ys, mask):
        live = mask > 0
        preds, errs = [], []
        for t in range(xs.shape[1]):
            new, out = lrn.step_fn(state, xs[:, t], ys[:, t])
            state = type(state)(*(_gate_leaf(live[:, t], a, b)
                                  for a, b in zip(new, state)))
            preds.append(out.prediction)
            errs.append(out.error)
        return state, StepOut(prediction=torch.stack(preds, 1),
                              error=torch.stack(errs, 1))

    return step


def make_chunk_step(learner: str, feature_map: FeatureLike = None, *,
                    mode: str = "auto", input_dim: Optional[int] = None,
                    device="cuda", **hp) -> Callable:
    """Chunked step ``(state, xs (B, T, d), ys (B, T), mask (B, T)) ->
    (state, StepOut)`` (the queue's step): one chunk-kernel launch for klms
    and krls, the generic masked loop for the other families."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner in ("klms", "krls"):
        tf = _fused_map(learner, feature_map, input_dim)
        chunk_step = (krls_bank_chunk_step if learner == "krls"
                      else klms_bank_chunk_step)
        rate = h["beta"] if learner == "krls" else h["mu"]

        def step(state, xs, ys, mask):
            return chunk_step(state, xs, ys, tf, rate, mask, mode=mode)

        return step
    return _generic_chunk_server(
        build_learner(learner, feature_map, input_dim, device, **hp))


def run_stream(learner: str, feature_map: Optional[FeatureLike], xs, ys, *,
               state=None, mode: str = "auto", chunk: Optional[int] = None,
               input_dim: Optional[int] = None, **hp):
    """Serve B lockstep tenant streams ``xs (B, n, d)``, ``ys (B, n)``;
    ``chunk=T`` picks the chunk-kernel schedule of the fused families. The
    other families run their batched step over time on the device of
    ``xs``."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner == "krls":
        _fused_map(learner, feature_map, input_dim)
        return krls_bank_run(feature_map, xs, ys, h["lam"], h["beta"],
                             state=state, mode=mode, chunk=chunk)
    if learner == "klms":
        _fused_map(learner, feature_map, input_dim)
        return klms_bank_run(feature_map, xs, ys, h["mu"], state=state,
                             mode=mode, chunk=chunk)
    lrn = build_learner(learner, feature_map, input_dim, xs.device, **hp)
    if state is None:
        state = bank_init(lrn, xs.shape[0])
    return bank_run(lrn, state, xs, ys)


def reset_slots(state, slots, *, learner: Optional[str] = None,
                lam: float = 1e-4):
    """Bank ``slots`` (indices) on a fresh row, out of place. The family
    follows the state (``learner=`` overrides): LMS rows zero, RLS rows
    re-seed ``P_0 = I / lam``, dictionary rows zero every buffer."""
    if learner is None:
        learner = "krls" if isinstance(state, RLSState) else "klms"
    idx = torch.as_tensor(slots, dtype=torch.long, device=state[0].device)
    leaves = [a.clone() for a in state]
    for a in leaves:
        a[idx] = 0
    if learner == "krls":
        dfeat = state.pmat.shape[-1]
        leaves[1][idx] = torch.eye(dfeat, dtype=state.pmat.dtype,
                                   device=state.pmat.device) / lam
    return type(state)(*leaves)


def make_queue(learner: str = "klms", feature_map: FeatureLike = None,
               bank: int = 8, *, chunk: int = 16, mode: str = "auto",
               adaptive: bool = False, state=None,
               input_dim: Optional[int] = None, device="cuda",
               **hp) -> MicroBatchQueue:
    """Ready-to-serve micro-batch queue: a fresh bank state on ``device``
    plus the family's chunk step, coalescing ragged arrivals into masked
    ``(B, T)`` launches. ``input_dim`` follows ``repro``'s rule (the map's
    width wins)."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    dev = resolve_device(device)
    d = _resolve_input_dim(learner, feature_map, input_dim)
    fm = as_trig(feature_map).to(dev) if feature_map is not None else None
    if state is None:
        if learner in ("klms", "nklms"):
            state = klms_bank_init(_fused_map(learner, fm, input_dim), bank)
        elif learner == "krls":
            state = krls_bank_init(_fused_map(learner, fm, input_dim), bank,
                                   h["lam"])
        else:
            state = bank_init(build_learner(learner, fm, input_dim, dev,
                                            **hp), bank)
    return MicroBatchQueue(
        make_chunk_step(learner, fm, mode=mode, input_dim=input_dim,
                        device=dev, **hp),
        state, d, chunk=chunk, adaptive=adaptive,
    )


class Server:
    """One serving object per bank: write path, read path and metrics.

    Built by :func:`make_server`. ``tenant`` arguments are bank-slot
    indices in ``[0, slots)``. Metrics (``self.metrics``): counters
    ``requests.write`` / ``requests.read``, gauge ``queue.backlog``,
    histograms ``latency.write_us`` / ``latency.read_us`` (host clock),
    lifecycle counters ``evictions`` / ``readmissions`` / ``resets``.
    The RFF families read through the fused predict kernel; the
    dictionary learners through their ``predict_fn`` on the frozen
    replica.
    """

    def __init__(self, inner: SnapshotServer, *, learner: str,
                 feature_map: Optional[FeatureLike], hp: dict,
                 lrn: Optional[OnlineLearner] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 latency_clock: Callable[[], float] = time.perf_counter):
        self._inner = inner
        self.learner = learner
        self.feature_map = feature_map
        self._hp = hp
        self._lrn = lrn
        self._theta_family = learner in _THETA_FAMILIES
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

    def _slot_predict(self, tenant: int, xs) -> torch.Tensor:
        if self._theta_family:
            return self._inner.predict(tenant, xs)
        xq = self._inner._queries(xs)
        single = xq.ndim == 1
        if single:
            xq = xq[None]
        row = tenant_row(self._inner.snapshot.state, tenant)
        pred = self._lrn.predict_fn(row, xq)
        return pred[0] if single else pred

    def predict(self, tenant: int, xs) -> torch.Tensor:
        """Serve queries for one tenant from the frozen read replica:
        ``xs (d,)`` -> scalar, ``(Q, d)`` -> ``(Q,)``."""
        t0 = self._lat()
        self.metrics.counter("requests.read").inc()
        pred = self._slot_predict(tenant, xs)
        self.metrics.histogram("latency.read_us").observe(
            (self._lat() - t0) * 1e6
        )
        return pred

    def predict_block(self, xq) -> torch.Tensor:
        """Serve a ``(B, Q, d)`` query block over the whole bank from the
        frozen replica -> ``(B, Q)`` (one launch for the RFF families)."""
        t0 = self._lat()
        self.metrics.counter("requests.read").inc()
        if self._theta_family:
            pred = self._inner.predict_block(xq)
        else:
            pred = self._lrn.predict_fn(per_query(self._inner.snapshot.state),
                                        self._inner._queries(xq))
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
        the server's ``rebuild_mode`` (the dictionary learners replay
        sequentially). Returns the ticks replayed."""
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
    """The serving facade: one :class:`Server` for any learner family.

    Args:
      learner: ``"klms"``, ``"nklms"``, ``"qklms"``, ``"krls"`` or
        ``"ald"``.
      feature_map: a trig feature map, :class:`FeatureMap` or
        :class:`TrigFeatures` (moved to ``device``); the RFF families need
        one, the dictionary learners take ``input_dim=`` alone.
      input_dim: ``repro``'s input width; a feature map's width wins and
        ``input_dim`` is then ignored.
      bank: number of bank slots B.
      chunk / mode / adaptive: micro-batch queue knobs (serve/queue.py);
        ``mode`` also drives the read path and the replay kernels ("auto",
        "cuda" or "ref").
      precision / publish_every / age_watermark / size_watermark / clock:
        snapshot-tier knobs (serve/snapshot.py).
      metrics: a shared :class:`MetricsRegistry` (fresh one by default).
      state: initial bank state (fresh by default).
      device: where the state and the map live; ``"cuda"`` by default,
        which raises when there is no CUDA device.
      log_capacity: per-tenant replay-log ring size (serve/snapshot.py);
        None keeps no log, and a readmitted tenant restarts cold.
      rebuild_mode: replay schedule of ``readmit`` (core/scan.py):
        ``"scan"``, ``"blocked"`` or ``"sequential"`` (bit for bit the
        training path); its kernels follow ``mode``. The dictionary
        learners always replay sequentially.
      **kw: family hyperparameters, ``repro``'s table: ``mu``, ``eps``,
        ``lam``, ``beta``, ``sigma``, ``quant_eps``, ``nu``, ``capacity``.
        The knobs of later slices (``policy``, ``trace``, ``probe``,
        ``recovery``, ``wal``, ...) raise ``NotImplementedError``.
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
    if rebuild_mode not in _REBUILD_MODES:
        raise ValueError(
            f"unknown rebuild_mode {rebuild_mode!r}; pick from {_REBUILD_MODES}"
        )
    dev = resolve_device(device)
    fm = as_trig(feature_map).to(dev) if feature_map is not None else None
    lrn = build_learner(learner, fm, input_dim, dev, **kw)
    queue = make_queue(learner, fm, bank, chunk=chunk, mode=mode,
                       adaptive=adaptive, state=state, input_dim=input_dim,
                       device=dev, **kw)

    if learner in _THETA_FAMILIES:
        def rebuild_fn(bank_state, slot, xs, ys):
            return rebuild_tenant(bank_state, slot, fm, xs, ys, mu=h["mu"],
                                  lam=h["lam"], beta=h["beta"],
                                  mode=rebuild_mode, kernel_mode=mode,
                                  normalized=learner == "nklms",
                                  eps=h["eps"])

        def evict_fn(bank_state, slot):
            return evict_tenant(bank_state, slot, lam=h["lam"])
    else:
        def rebuild_fn(bank_state, slot, xs, ys):
            like = bank_state[0]
            row = lrn.rebuild(
                torch.as_tensor(xs, dtype=like.dtype, device=like.device),
                torch.as_tensor(ys, dtype=like.dtype, device=like.device),
                mode="sequential")
            return set_tenant_row(bank_state, slot, row)

        def evict_fn(bank_state, slot):
            fresh = tenant_row(bank_state, slot)
            return set_tenant_row(bank_state, slot,
                                  type(fresh)(*map(torch.zeros_like, fresh)))

    inner = SnapshotServer(
        queue, fm, publish_every, mode=mode, precision=precision,
        age_watermark=age_watermark, size_watermark=size_watermark,
        clock=clock, log_capacity=log_capacity, evict_fn=evict_fn,
        rebuild_fn=rebuild_fn,
    )
    return Server(inner, learner=learner, feature_map=fm, hp=h, lrn=lrn,
                  metrics=metrics)
