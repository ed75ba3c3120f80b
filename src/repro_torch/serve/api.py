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
their path is plain PyTorch on the card. Every feature family serves: a
trig map (rff, orf, qmc, gq) runs the kernels, taylor the generic route
of the bank tiers.

Policy mode (``make_server(policy=...)``, ``serve/policy.py``): tenant ids
are unbounded and the bank is a cache of hot tenants. A write miss admits
the tenant (evicting the coldest incumbent, subject to the admission
floor) and installs it by replaying its log; a rejected arrival is logged,
not trained; ``Server.resize`` grows and shrinks the bank in powers of
two, surviving rows moved bit for bit.

Observability and recovery (``make_server(trace=, probe=, recovery=,
wal=)``, ``repro_torch.obs`` and ``serve/recovery.py``): a tracer records
nested ``serve.*`` / ``queue.*`` / ``snapshot.*`` / ``bank.*`` /
``kernel.*`` spans, a probe monitor folds the queue's numerics tap at each
flush, a recovery policy quarantines and repairs a degraded tenant, and a
write-ahead log with ``Server.checkpoint`` and ``restore_checkpoint``
brings a killed server back bit for bit.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bank import (
    bank_init,
    bank_run,
    bank_size,
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
    resize_bank,
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
from repro_torch.features.base import FeatureLike, as_trig_or_none, map_to
from repro_torch.features.base import input_dim as fm_input_dim
from repro_torch.kernels.ref import blocking, to_device
from repro_torch.obs import probes as _probes
from repro_torch.obs import telemetry as _telemetry
from repro_torch.obs import trace as _obtrace
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.policy import SlotPolicy
from repro_torch.serve.queue import MicroBatchQueue
from repro_torch.serve.recovery import (
    DurableLog,
    RecoveryPolicy,
    save_checkpoint,
)
from repro_torch.serve.snapshot import ReplayLog, SnapshotServer, predict_row

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


# ---------------------------------------------------------------------------
# Deprecation shims: the pre-facade factory names (serve/bank_loop.py,
# serve/queue.py, serve/snapshot.py) wrap this helper, as in repro.
# ---------------------------------------------------------------------------

_DEPRECATION_FIRED: set[str] = set()


def _deprecated(name: str, replacement: str) -> None:
    """Emit one DeprecationWarning per old factory name per process."""
    if name in _DEPRECATION_FIRED:
        return
    _DEPRECATION_FIRED.add(name)
    warnings.warn(
        f"repro_torch.serve.{name} is deprecated; use {replacement}",
        DeprecationWarning,
        stacklevel=3,
    )


def _reset_deprecation_state() -> None:
    """Testing hook: re-arm the once-per-name deprecation latches."""
    _DEPRECATION_FIRED.clear()


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
    """The feature map of a fused family (klms, krls), checked as
    ``repro`` checks it (``input_dim`` follows the width rule): its trig
    form, taken once, or the map itself for a family without one (taylor,
    which the bank tiers run on the generic route)."""
    if feature_map is None:
        raise ValueError(f"learner {learner!r} requires feature_map=")
    _resolve_input_dim(learner, feature_map, input_dim)
    tf = as_trig_or_none(feature_map)
    return feature_map if tf is None else tf


def make_tick(learner: str, feature_map: FeatureLike = None, *,
              mode: str = "auto", input_dim: Optional[int] = None,
              device="cuda", **hp) -> Callable:
    """Lockstep tick ``(state, xs (B, d), ys (B,)) -> (state, StepOut)``:
    klms and krls through their fused step kernels (the generic route for
    taylor), the other families
    through their batched ``OnlineLearner`` step (``device`` places the
    dictionary learners)."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner in ("klms", "krls"):
        fm = _fused_map(learner, feature_map, input_dim)
        bank_step = krls_bank_step if learner == "krls" else klms_bank_step
        rate = h["beta"] if learner == "krls" else h["mu"]

        def tick(state, xs, ys):
            return bank_step(state, xs, ys, fm, rate, mode=mode)

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
    and krls (the generic route for taylor), the generic masked loop for
    the other families."""
    _check_learner(learner)
    h = _resolve_hp(hp)
    if learner in ("klms", "krls"):
        fm = _fused_map(learner, feature_map, input_dim)
        chunk_step = (krls_bank_chunk_step if learner == "krls"
                      else klms_bank_chunk_step)
        rate = h["beta"] if learner == "krls" else h["mu"]

        def step(state, xs, ys, mask):
            with _obtrace.span("lockstep.write", learner=learner,
                               B=xs.shape[0], T=xs.shape[1]):
                return chunk_step(state, xs, ys, fm, rate, mask, mode=mode)

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
    if not _obtrace.recording():
        return _reset_rows(state, slots, learner, lam)
    with _obtrace.span("lockstep.reset", learner=learner,
                       rows=torch.as_tensor(slots).numel(),
                       bytes_cloned=sum(a.numel() * a.element_size()
                                        for a in state)):
        return _reset_rows(state, slots, learner, lam)


def _reset_rows(state, slots, learner, lam):
    idx = to_device(slots, torch.long, state[0].device,
                    "reset_slots.index")
    leaves = [a.clone() for a in state]
    for a in leaves:
        # The 0 is a host scalar: index_put_ copies it to the device.
        with blocking(a.device, "reset_slots.fill"):
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
    fm = map_to(feature_map, dev) if feature_map is not None else None
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
    """One serving object per bank: write path, read path, lifecycle,
    policy, metrics and observability.

    Built by :func:`make_server`. Without a policy, ``tenant`` arguments
    are bank-slot indices in ``[0, slots)``. With one (``policy=``),
    ``tenant`` is any int id and the bank is a cache of hot tenants: a
    write miss admits the tenant (evicting the coldest incumbent, subject
    to the admission floor) and installs it by replaying its log from
    ``self.log`` (keyed by tenant id); a rejected arrival is logged, not
    trained; a read of a non-resident tenant is answered cold (the fresh
    row's zeros) and admits nobody; :meth:`resize` grows or shrinks the
    bank in powers of two, moving surviving rows bit for bit.

    Metrics (``self.metrics``): counters ``requests.write`` /
    ``requests.read``, lifecycle counters ``evictions`` / ``readmissions``
    / ``resets``, with a policy ``bank.hits`` / ``bank.misses`` /
    ``admission.rejects`` / ``read.cold`` / ``resizes``; gauge
    ``queue.backlog``; histograms ``latency.write_us`` /
    ``latency.read_us`` (host clock, around the whole call: flushes and
    installs land in the write tail). The RFF families read through the
    fused predict kernel (a trig map) or ``featurize`` (taylor); the
    dictionary learners through their ``predict_fn`` on the frozen
    replica.

    Observability: a tracer (``self.tracer``) is activated around every
    public method, so the queue, snapshot, bank and kernel spans nest
    under the request; a probe monitor (``self.probe``) folds the queue's
    numerics tap once a flush, with the expected-ticks ledger's
    ``ticks_lag``; a recovery policy (``self.recovery``) acts on its
    events; a write-ahead log (``self.wal``) records every submit before
    it is queued. :meth:`observability` exports all of it as one dict.
    """

    def __init__(self, inner: SnapshotServer, *, learner: str,
                 feature_map: Optional[FeatureLike], hp: dict,
                 lrn: Optional[OnlineLearner] = None,
                 policy: Optional[SlotPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 log_capacity: Optional[int] = None,
                 auto_resize: bool = False,
                 latency_clock: Callable[[], float] = time.perf_counter,
                 tracer: Optional[_obtrace.Tracer] = None,
                 probe=None,
                 recovery: Optional[RecoveryPolicy] = None,
                 wal: Optional[DurableLog] = None):
        self._inner = inner
        self.learner = learner
        self.feature_map = feature_map
        self._hp = hp
        self._lrn = lrn
        self.policy = policy
        self.auto_resize = auto_resize
        self._theta_family = learner in _THETA_FAMILIES
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lat = latency_clock
        self.tracer = tracer
        self.wal = wal
        self._wal_suspended = False
        # Expected-ticks ledger, slot-keyed: the observations this facade
        # queued that the bank must train. ``ticks_lag`` compares it with
        # the backlog plus the state's step counters.
        self._expected: dict[int, int] = {}
        self._probe_folded_flush = -1
        if probe:
            self.probe = _probes.ProbeMonitor(
                probe if isinstance(probe, dict) else None,
                registry=self.metrics)
            inner.queue.attach_probe(_probes.stats_tap)
        else:
            self.probe = None
        if policy is not None:
            # Tenant ids are unbounded: the log is keyed by id (the inner,
            # slot-keyed one is off).
            self.log = ReplayLog(capacity=log_capacity or 256,
                                 dtype=inner.queue._dtype)
            if policy.cost_fn is None:
                policy.cost_fn = self._rebuild_cost
        else:
            self.log = inner.log
        # A row captured before any training: the pad row of bank growth.
        self._fresh_row = tenant_row(inner.queue.state, 0)
        self.recovery = recovery
        if recovery is not None:
            recovery.bind(self)

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

    @property
    def resident(self) -> dict:
        """tenant -> slot map (the identity without a policy)."""
        if self.policy is None:
            return {t: t for t in range(self.slots)}
        return self.policy.resident

    def hit_rate(self) -> float:
        """Resident-lookup hit fraction over all reads and writes so far."""
        hits = self.metrics.count("bank.hits")
        misses = self.metrics.count("bank.misses")
        return hits / (hits + misses) if hits + misses else 1.0

    # -- observability -----------------------------------------------------

    def _act(self):
        """Activate this server's tracer (a no-op context untraced)."""
        return _obtrace.activate(self.tracer)

    def _slot_lags(self) -> list[int]:
        """Per-slot expected minus trained ticks: the ledger against the
        backlog plus the state's step counters. A positive entry means
        queued observations never reached the bank (``ticks_lag``, a
        dropped flush); a negative one (the queue fed directly) never
        fires."""
        step = self._inner.queue.state.step.tolist()
        backlog = self._inner.queue.backlog()
        return [self._expected.get(s, 0) - backlog[s] - int(step[s])
                for s in range(self.slots)]

    def _note_queued(self, slot: int) -> None:
        self._expected[slot] = self._expected.get(slot, 0) + 1

    def _probe_update(self) -> None:
        """Fold the queue's latest tap readout into the monitor, once a
        flush (a stale readout would fire its events again), in one
        device-to-host copy; then let the recovery policy act."""
        if self.probe is None:
            return
        queue = self._inner.queue
        tap = queue.last_probe
        if tap is None or queue.flushes == self._probe_folded_flush:
            if self.recovery is not None:
                self.recovery.process()  # backoff retries between flushes
            return
        self._probe_folded_flush = queue.flushes
        stats = dict(zip(tap, torch.stack(list(tap.values())).tolist()))
        stats["ticks_lag"] = float(max(self._slot_lags(), default=0))
        if (self.recovery is not None
                and self.recovery.reference_clock is not None):
            stats["clock_skew"] = self.recovery.measure_skew()
        self.probe.update(stats, tick=queue.ticks_served,
                          staleness=self._inner.staleness)
        if self.recovery is not None:
            self.recovery.process()

    def check_read_contract(self, xq) -> float:
        """The bf16 read's relative error against the f32 read on a ``(B,
        Q, d)`` query block over the current replica, folded into the
        probe monitor when there is one. RFF families only."""
        if not self._theta_family:
            raise ValueError(
                "bf16 read contract applies to the fused theta families")
        with self._act(), _obtrace.span("serve.read_contract"):
            err = _probes.bf16_read_error(
                self._inner.snapshot.state, self.feature_map,
                self._inner._queries(xq), mode=self._inner.mode)
            if self.probe is not None:
                tap = {k: v for k, v in self.probe.last_stats.items()
                       if k not in ("staleness_ticks", "bf16_read_error",
                                    "ticks_lag", "clock_skew")}
                self.probe.update(tap, tick=self._inner.queue.ticks_served,
                                  staleness=self._inner.staleness,
                                  bf16_err=err)
        return err

    def observability(self) -> dict:
        """Everything observable about this server as one plain dict::

            {"metrics": MetricsRegistry.snapshot(),
             "dispatch": repro_torch.obs.telemetry.snapshot(),  # process
             "probes": ProbeMonitor.state() | None,
             "trace": Tracer.summary() | None}
        """
        return {
            "metrics": self.metrics.snapshot(),
            "dispatch": _telemetry.snapshot(),
            "probes": self.probe.state() if self.probe is not None else None,
            "trace": (self.tracer.summary()
                      if self.tracer is not None else None),
        }

    # -- write path --------------------------------------------------------

    def submit(self, tenant: int, x, y) -> None:
        """Enqueue one observation for ``tenant`` (a watermark may flush;
        with a policy, admitting, evicting or rejecting first). With a WAL
        the arrival is appended before anything else happens to it."""
        t0 = self._lat()
        with self._act(), _obtrace.span("serve.submit", tenant=tenant):
            self.metrics.counter("requests.write").inc()
            if self.wal is not None and not self._wal_suspended:
                # Only an arrival the server accepts reaches the log.
                queue = self._inner.queue
                if self.policy is None:
                    queue.check_arrival(tenant, x)
                else:
                    queue.check_x(x)
                self.wal.append(tenant, x, y)
            if (self.recovery is not None
                    and tenant in self.recovery.quarantined):
                self._quarantined_submit(tenant, x, y)
            elif self.policy is None:
                queued = tenant not in self._inner._evicted
                self._inner.submit(tenant, x, y)  # checks the arrival
                if queued:
                    self._note_queued(tenant)
            else:
                self._policy_submit(tenant, x, y)
            self._probe_update()
            self.metrics.set_gauge(
                "queue.backlog", float(sum(self._inner.queue.backlog())))
            self.metrics.histogram("latency.write_us").observe(
                (self._lat() - t0) * 1e6)
            if self.policy is not None and self.auto_resize:
                target = self.policy.suggest_size()
                if target != self.slots:
                    self.resize(target)

    def _policy_submit(self, tenant: int, x, y) -> None:
        x = self._inner.queue.check_x(x)
        pol = self.policy
        pol.touch(tenant)
        slot = pol.lookup(tenant)
        if slot is not None:
            self.metrics.counter("bank.hits").inc()
        else:
            self.metrics.counter("bank.misses").inc()
            decision = pol.admit(tenant)
            if decision.action == "reject":
                # Logged, not trained: the history stays whole for a later
                # admission, and the bank spends nothing on the tenant.
                self.metrics.counter("admission.rejects").inc()
                self.log.append(tenant, x, y)
                return
            if decision.action == "evict":
                self.metrics.counter("evictions").inc()
                self._inner.release_slot(decision.slot)
                self._expected[decision.slot] = 0
            slot = decision.slot
            self._install(tenant, slot)
        self.log.append(tenant, x, y)
        self._note_queued(slot)
        self._inner.submit(slot, x, y)

    def _quarantined_submit(self, tenant: int, x, y) -> None:
        """A quarantined tenant's arrivals are logged, never trained: a
        rebuild replays them, a reset forfeits them with the history. The
        policy's clock still ticks, so admissions stay deterministic."""
        self.metrics.counter("recovery.deferred").inc()
        if self.policy is not None:
            self.policy.touch(tenant)
        if self.log is not None:
            self.log.append(tenant, self._inner.queue.check_x(x), y)

    def _install(self, tenant: int, slot: int) -> int:
        """Rebuild ``tenant``'s state from its log into ``slot`` (with the
        server's ``rebuild_mode``) and publish; an empty log leaves the
        fresh row. Returns the ticks replayed."""
        n = self.log.size(tenant)
        if n:
            with _obtrace.span("serve.install", tenant=tenant, slot=slot,
                               ticks=n):
                xs, ys = self.log.arrays(tenant)
                inner = self._inner
                inner.queue.state = inner._rebuild_fn(inner.queue.state,
                                                      slot, xs, ys)
                self.metrics.counter("readmissions").inc()
                inner.publish()
        self._expected[slot] = n
        return n

    def flush(self) -> dict:
        with self._act(), _obtrace.span("serve.flush"):
            res = self._inner.flush()
            self._probe_update()
            return res

    def maybe_flush(self) -> dict:
        with self._act():
            res = self._inner.maybe_flush()
            if res:
                self._probe_update()
            return res

    def drain(self) -> dict:
        with self._act(), _obtrace.span("serve.drain"):
            res = self._inner.drain()
            self._probe_update()
            return res

    # -- read path ---------------------------------------------------------

    def _slot_predict(self, slot: int, xs) -> torch.Tensor:
        if self._theta_family:
            return self._inner.predict(slot, xs)
        xq = self._inner._queries(xs)
        single = xq.ndim == 1
        if single:
            xq = xq[None]
        row = tenant_row(self._inner.snapshot.state, slot)
        pred = self._lrn.predict_fn(row, xq)
        return pred[0] if single else pred

    def _cold(self, xs) -> torch.Tensor:
        """The fresh row's prediction: zeros, ``()`` or ``(Q,)``."""
        shape = () if np.ndim(xs) == 1 else (len(xs),)
        lead = self._inner.queue.state[0]
        return torch.zeros(shape, dtype=lead.dtype, device=lead.device)

    def predict(self, tenant: int, xs) -> torch.Tensor:
        """Serve queries for one tenant from the frozen read replica:
        ``xs (d,)`` -> scalar, ``(Q, d)`` -> ``(Q,)``. With a policy, a
        tenant that is not resident gets the cold prediction (zeros) and
        is not admitted, so a read costs the same whatever the log. A
        quarantined tenant is served from its last healthy row."""
        t0 = self._lat()
        with self._act(), _obtrace.span("serve.predict", tenant=tenant):
            self.metrics.counter("requests.read").inc()
            if (self.recovery is not None
                    and tenant in self.recovery.quarantined):
                pred = self._quarantined_predict(tenant, xs)
            elif self.policy is None:
                pred = self._slot_predict(tenant, xs)
            else:
                self.policy.touch(tenant)
                slot = self.policy.lookup(tenant)
                if slot is None:
                    self.metrics.counter("bank.misses").inc()
                    self.metrics.counter("read.cold").inc()
                    pred = self._cold(xs)
                else:
                    self.metrics.counter("bank.hits").inc()
                    pred = self._slot_predict(slot, xs)
            self.metrics.histogram("latency.read_us").observe(
                (self._lat() - t0) * 1e6)
            return pred

    def _quarantined_predict(self, tenant: int, xs) -> torch.Tensor:
        """A quarantined tenant's reads, from the captured last-healthy
        replica row (cold zeros if it was never seen healthy): the
        degraded slot is never read. RFF rows go through
        :func:`~repro_torch.serve.snapshot.predict_row`, one read launch
        at B = 1."""
        self.metrics.counter("read.quarantined").inc()
        if self.policy is not None:
            self.policy.touch(tenant)
        row = self.recovery.healthy_row(tenant)
        if row is None:
            return self._cold(xs)
        xq = self._inner._queries(xs)
        single = xq.ndim == 1
        if single:
            xq = xq[None]
        if self._theta_family:
            pred = predict_row(row.theta, xq, self._inner.rff,
                               mode=self._inner.mode,
                               precision=self._inner.precision)
        else:
            pred = self._lrn.predict_fn(row, xq)
        return pred[0] if single else pred

    def predict_block(self, xq) -> torch.Tensor:
        """Serve a ``(B, Q, d)`` query block over the whole bank (slot
        space) from the frozen replica -> ``(B, Q)`` (one launch for the
        RFF families with a trig map)."""
        t0 = self._lat()
        with self._act(), _obtrace.span("serve.predict_block"):
            self.metrics.counter("requests.read").inc()
            if self._theta_family:
                pred = self._inner.predict_block(xq)
            else:
                pred = self._lrn.predict_fn(
                    per_query(self._inner.snapshot.state),
                    self._inner._queries(xq))
            self.metrics.histogram("latency.read_us").observe(
                (self._lat() - t0) * 1e6)
            return pred

    # -- lifecycle ---------------------------------------------------------

    @property
    def evicted(self) -> frozenset[int]:
        """Slots released without a policy (the policy tier's evicted
        tenants are those not in :attr:`resident`)."""
        return self._inner.evicted

    def evict(self, tenant: int) -> int:
        """Release ``tenant``'s slot (a fresh row is parked there). Without
        a policy its later arrivals are only logged; with one the slot is
        free for the next admission. Returns the dropped pending count."""
        with self._act(), _obtrace.span("serve.evict", tenant=tenant):
            if self.policy is None:
                dropped = self._inner.evict(tenant)
                self._expected[tenant] = 0
            else:
                slot = self.policy.release(tenant)
                if slot is None:
                    return 0
                dropped = self._inner.release_slot(slot)
                self._expected[slot] = 0
            self.metrics.counter("evictions").inc()
            return dropped

    def readmit(self, tenant: int) -> int:
        """Re-admit ``tenant``, rebuilding its slot from the replay log with
        the server's ``rebuild_mode`` (the dictionary learners replay
        sequentially). With a policy this bypasses the admission floor (an
        operator's decision), evicting the coldest incumbent of a full
        bank. Returns the ticks replayed."""
        with self._act(), _obtrace.span("serve.readmit", tenant=tenant):
            if self.policy is None:
                n = self._inner.readmit(tenant)
                self._expected[tenant] = n
                self.metrics.counter("readmissions").inc()
                return n
            pol = self.policy
            if pol.lookup(tenant) is not None:
                return 0
            pol.touch(tenant)
            decision = pol.admit(tenant, force=True)
            if decision.action == "evict":
                self.metrics.counter("evictions").inc()
                self._inner.release_slot(decision.slot)
                self._expected[decision.slot] = 0
            return self._install(tenant, decision.slot)

    def reset_tenant(self, tenant: int) -> int:
        """Reset one tenant to a fresh row and forget its replay history
        (with a policy, a resident tenant keeps its slot): the last rung of
        the recovery ladder. Returns the dropped pending count."""
        with self._act(), _obtrace.span("serve.reset_tenant", tenant=tenant):
            self.metrics.counter("resets").inc()
            if self.policy is None:
                dropped = self._inner.reset_tenant(tenant)
                self._expected[tenant] = 0
                return dropped
            self.log.clear(tenant)
            slot = self.policy.lookup(tenant)
            if slot is None:
                return 0
            inner = self._inner
            dropped = inner.queue.drop_pending(slot)
            inner._arrival_times[slot].clear()
            inner.queue.state = inner._evict_fn(inner.queue.state, slot)
            inner.publish()
            self._expected[slot] = 0
            return dropped

    def checkpoint(self, directory, *, keep: int = 3) -> str:
        """Write one durable checkpoint generation of this server
        (serve/recovery.py); returns its path."""
        with self._act():
            return save_checkpoint(self, directory, keep=keep)

    def reset(self, state=None) -> None:
        """Restart on a fresh bank state (every slot the fresh row by
        default): queue, replica, logs, ledger, residency and the policy's
        clocks drop to zero. Drain pending observations first."""
        if state is None:
            state = type(self._fresh_row)(*(
                r.expand(self.slots, *r.shape).clone()
                for r in self._fresh_row))
        self._inner.reset(state)
        self._expected.clear()
        if self.policy is not None:
            self.log.clear()
            pol = self.policy
            pol.clock = 0
            pol.last_touch.clear()
            pol.touches.clear()
            pol._resident.clear()
            pol.set_slots(bank_size(state))

    # -- capacity ----------------------------------------------------------

    def resize(self, new_slots: int) -> None:
        """Grow or shrink the bank to ``new_slots`` (a power of two).

        Growth appends fresh rows; resident rows are untouched. Shrinking
        first evicts the coldest residents until the rest fit, then moves
        each resident above ``new_slots`` into a free slot below it (one
        indexed copy of every state leaf, bit for bit) and slices the bank.
        """
        if self.policy is None:
            raise ValueError("resize requires a policy tier")
        if new_slots < 1 or (new_slots & (new_slots - 1)):
            raise ValueError(
                f"new_slots must be a power of two, got {new_slots}")
        if new_slots == self.slots:
            return
        with self._act(), _obtrace.span("serve.resize", slots=self.slots,
                                        new_slots=new_slots):
            self.metrics.counter("resizes").inc()
            pol, inner = self.policy, self._inner
            if new_slots < self.slots:
                while pol.occupancy > new_slots:
                    self.evict(pol.victim())
                used = set(pol.resident.values())
                free_low = [s for s in range(new_slots) if s not in used]
                moves = [(tenant, slot, free_low.pop(0)) for tenant, slot in
                         sorted(pol.resident.items(), key=lambda kv: kv[1])
                         if slot >= new_slots]
                if moves:
                    dev = inner.queue.device
                    src = torch.tensor([m[1] for m in moves], device=dev)
                    dst = torch.tensor([m[2] for m in moves], device=dev)
                    leaves = [a.clone() for a in inner.queue.state]
                    for a in leaves:
                        a[dst] = a[src]
                    inner.queue.state = type(inner.queue.state)(*leaves)
                for tenant, slot, dst_slot in moves:
                    inner.move_slot(slot, dst_slot)
                    self._expected[dst_slot] = self._expected.pop(slot, 0)
                    pol.move(tenant, dst_slot)
            inner.adopt_resized(resize_bank(inner.queue.state, new_slots,
                                            fresh_row=self._fresh_row))
            self._expected = {s: v for s, v in self._expected.items()
                              if s < new_slots}
            pol.set_slots(new_slots)

    def _rebuild_cost(self, tenant: int) -> float:
        """Rebuild-cost estimate for the ``cost`` scorer (``repro``'s):
        log length times the family's cost a tick, plus KRLS's one (D, D)
        solve; the dictionary learners replay over their capacity-M
        buffers (QKLMS O(M) a tick, ALD O(M^2))."""
        n = max(1, self.log.size(tenant))
        if self._theta_family:
            dfeat = self.feature_map.num_features
            if self.learner == "krls":
                return float(n) * dfeat * dfeat + float(dfeat) ** 3
            return float(n) * dfeat
        cap = self._hp["capacity"]
        if self.learner == "ald":
            return float(n) * cap * cap
        return float(n) * cap


def _resolve_policy(policy, bank: int) -> Optional[SlotPolicy]:
    if policy is None:
        return None
    if isinstance(policy, SlotPolicy):
        if policy.slots != bank:
            raise ValueError(
                f"policy manages {policy.slots} slots but bank={bank}"
            )
        return policy
    if isinstance(policy, str):
        return SlotPolicy(bank, scorer=policy)
    if isinstance(policy, dict):
        return SlotPolicy(bank, **policy)
    raise TypeError(
        f"policy must be None, str, dict or SlotPolicy; got {policy!r}")


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
    policy=None,
    auto_resize: bool = False,
    trace=None,
    probe=None,
    recovery=None,
    wal=None,
    **kw,
) -> Server:
    """The serving facade: one :class:`Server` for any learner family.

    Args:
      learner: ``"klms"``, ``"nklms"``, ``"qklms"``, ``"krls"`` or
        ``"ald"``.
      feature_map: any feature family (:class:`FeatureMap`,
        :class:`TrigFeatures` or an RFF draw; moved to ``device``): a trig
        map runs the kernels, taylor the generic route. The RFF families
        need one, the dictionary learners take ``input_dim=`` alone.
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
      log_capacity: per-tenant replay-log ring size (serve/snapshot.py).
        With a policy it defaults to 256; without one, None keeps no log,
        and a readmitted tenant restarts cold.
      rebuild_mode: replay schedule of ``readmit`` (core/scan.py):
        ``"scan"``, ``"blocked"`` or ``"sequential"`` (bit for bit the
        training path); its kernels follow ``mode``. The dictionary
        learners always replay sequentially. Policy installs take it too.
      policy: None (tenant == slot), a scorer name (``"lru"``, ``"lfu"``,
        ``"cost"``), a :class:`SlotPolicy` kwargs dict, or an instance
        managing ``bank`` slots.
      auto_resize: after each submit, apply the policy's power-of-two
        ``suggest_size``.
      trace: request tracing — ``True`` for a fresh
        :class:`~repro_torch.obs.trace.Tracer`, an int for one of that
        ring capacity, or a ready (possibly shared) instance; it lands on
        ``server.tracer``.
      probe: numerics probes — ``True`` runs
        :func:`~repro_torch.obs.probes.stats_tap` after every flush's
        chunk step and monitors it against ``DEFAULT_THRESHOLDS``; a dict
        overrides thresholds (``{"name": value}`` or ``{"name":
        ("min"|"max", value)}``). The monitor lands on ``server.probe``.
      recovery: probe-triggered repair (serve/recovery.py) — ``True`` for
        a default :class:`~repro_torch.serve.recovery.RecoveryPolicy`, a
        kwargs dict, or a ready instance; implies ``probe=True``.
      wal: a durable write-ahead log — a JSONL path or a ready
        :class:`~repro_torch.serve.recovery.DurableLog`; every accepted
        submit is appended before it is queued, and
        ``restore_checkpoint`` replays the suffix after a checkpoint.
      **kw: family hyperparameters, ``repro``'s table: ``mu``, ``eps``,
        ``lam``, ``beta``, ``sigma``, ``quant_eps``, ``nu``, ``capacity``.
    """
    _check_learner(learner)
    h = _resolve_hp(kw)
    if rebuild_mode not in _REBUILD_MODES:
        raise ValueError(
            f"unknown rebuild_mode {rebuild_mode!r}; pick from {_REBUILD_MODES}"
        )
    dev = resolve_device(device)
    fm = map_to(feature_map, dev) if feature_map is not None else None
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

    rec: Optional[RecoveryPolicy] = None
    if recovery:
        if isinstance(recovery, RecoveryPolicy):
            rec = recovery
        elif isinstance(recovery, dict):
            rec = RecoveryPolicy(**recovery)
        else:
            rec = RecoveryPolicy()
        if not probe:
            probe = True
    wal_log = wal if wal is None or isinstance(wal, DurableLog) else (
        DurableLog(wal))
    if isinstance(trace, _obtrace.Tracer):
        tracer = trace
    elif isinstance(trace, bool) or trace is None:
        tracer = _obtrace.Tracer() if trace else None
    else:
        tracer = _obtrace.Tracer(capacity=int(trace))
    pol = _resolve_policy(policy, bank)
    inner = SnapshotServer(
        queue, fm, publish_every, mode=mode, precision=precision,
        age_watermark=age_watermark, size_watermark=size_watermark,
        clock=clock, log_capacity=None if pol is not None else log_capacity,
        evict_fn=evict_fn, rebuild_fn=rebuild_fn,
    )
    return Server(inner, learner=learner, feature_map=fm, hp=h, lrn=lrn,
                  policy=pol, metrics=metrics, log_capacity=log_capacity,
                  auto_resize=auto_resize, tracer=tracer, probe=probe,
                  recovery=rec, wal=wal_log)
