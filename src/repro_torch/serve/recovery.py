"""Self-healing tier: probe-triggered repair and durable checkpoint/restore.

Counterpart of ``repro/serve/recovery.py``; obs/faults.py makes the
failures that drive it in tests.

* :class:`RecoveryPolicy` — subscribes to the server's probe monitor,
  localizes each degradation to a bank slot (per-slot
  :func:`~repro_torch.obs.probes.slot_stats`, on the rare event path),
  **quarantines** the tenant (reads served from its last healthy replica
  row, arrivals logged, not trained), then repairs by escalation::

      re-symmetrize P  ->  rebuild from the ReplayLog  ->  O(1) reset

  with bounded retries, exponential backoff a tenant, and every action
  traced and counted. A rebuild is tried only when the log is complete
  *and* finite; a repair escalates only on a *verified* failure, and an
  error raised inside a repair (a kernel's build or launch among them)
  propagates.
* :class:`DurableLog` — a JSONL write-ahead log of raw arrivals, the
  reference's format byte for byte: f32 -> Python float -> shortest repr,
  a torn final line tolerated.
* :func:`save_checkpoint` / :func:`restore_checkpoint` — atomic
  ``gen_N.ckpt`` generations of a whole ``serve.api.Server`` in
  ``repro``'s payload layout (``CKPT_FORMAT``: state leaves in field order
  as numpy arrays, queue, snapshot, policy, logs, evicted, expected, WAL
  seq), so a generation written by either package restores into the
  other's server; restore validates, installs every leaf on the server's
  device with its dtype, and replays the WAL suffix through ``submit``, so
  kill-at-any-flush -> restore equals the never-killed server bit for bit.

Quarantines and open repair episodes are not checkpointed: a restore
re-detects any degradation from the probes at the next flush.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.bank import resymmetrize_tenant, tenant_row
from repro_torch.features.base import uniform_trig_scale
from repro_torch.obs import telemetry as _telemetry
from repro_torch.obs import trace as _trace
from repro_torch.obs.probes import slot_stats

__all__ = [
    "CKPT_FORMAT",
    "DurableLog",
    "RecoveryPolicy",
    "save_checkpoint",
    "restore_checkpoint",
]

CKPT_FORMAT = "repro.server.ckpt/v1"

# The escalation ladder, cheapest repair first. ``resymmetrize`` is only
# offered to true RLS banks (a (B, D, D) P beside a theta row); every
# other reason starts at ``rebuild``.
LADDER = ("resymmetrize", "rebuild", "reset")

# Probes global to the server rather than to one slot: ``clock_skew`` has
# its own repair; the rest are recorded, not acted on.
_GLOBAL_PROBES = ("clock_skew", "staleness_ticks", "bf16_read_error")


def _is_rls_bank(state) -> bool:
    return hasattr(state, "pmat") and not hasattr(state, "centers")


def _host(a) -> np.ndarray:
    """A tensor or array as a host numpy array in its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------


class DurableLog:
    """Append-only JSONL write-ahead log of raw ``(tenant, x, y)`` arrivals.

    One line an arrival: ``{"s": seq, "t": tenant, "x": [...], "y": y}``,
    ``repro``'s bytes. Values are written as Python floats of the host
    array in its own dtype (a tensor goes through numpy first): an f32
    widens exactly and JSON's shortest repr keeps the double, so the f32
    read back is the one submitted (NaN and Inf use Python's literals).
    Sequence numbers run from 0 and resume past the last complete line of
    an existing file; a torn final line (a crash mid-append) is cut off.

    ``fsync=True`` makes every append durable against power loss at one
    fsync an arrival; by default appends reach the OS only (durable
    against a process crash).
    """

    def __init__(self, path, *, fsync: bool = False):
        self.path = str(path)
        self.fsync = fsync
        self.seq = -1
        if os.path.exists(self.path):
            # Find the resume seq and cut a torn tail: appending after an
            # unterminated fragment would weld the next record onto it.
            good_end = 0
            with open(self.path, "rb") as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    self.seq = rec["s"]
                    good_end += len(line)
            if good_end < os.path.getsize(self.path):
                with open(self.path, "ab") as fh:
                    fh.truncate(good_end)
        self._fh = open(self.path, "a", encoding="utf-8")

    def _scan(self):
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail: everything after it is garbage
                yield rec

    def append(self, tenant: int, x, y) -> int:
        """Record one arrival durably; returns its sequence number."""
        self.seq += 1
        rec = {
            "s": self.seq,
            "t": int(tenant),
            "x": [float(v) for v in _host(x).ravel()],
            "y": float(_host(y)),
        }
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        _telemetry.record_wal_append()
        return self.seq

    def entries(self, after: int = -1) -> list[dict]:
        """All complete records with ``seq > after``, in order."""
        return [rec for rec in self._scan() if rec["s"] > after]

    def close(self) -> None:
        self._fh.close()


# ---------------------------------------------------------------------------
# Probe-triggered recovery
# ---------------------------------------------------------------------------


@dataclass
class _Episode:
    """One tenant's open quarantine: its rung on the ladder and the row its
    reads are served from meanwhile."""

    tenant: int
    slot: int
    reason: str
    rung: int
    attempts: int = 0
    backoff_until: float = 0.0
    gave_up: bool = False
    healthy_row: Any = None
    actions: list = field(default_factory=list)


class RecoveryPolicy:
    """Quarantine-and-repair controller bound to one ``serve.api.Server``.

    The server's probe monitor pushes degradation events here
    (``ProbeMonitor.subscribe``); the subscriber only records them, and the
    server calls :meth:`process` right after each probe fold, so every
    state change happens outside the monitor's update.

    ``process`` localizes each event to a slot, captures the tenant's last
    healthy replica row and quarantines it: its reads are served from that
    row and its arrivals logged, not trained, until the episode closes.
    Repair walks :data:`LADDER` from a reason-dependent rung; each attempt
    is verified against the monitor's thresholds on the repaired slot. A
    verified failure escalates one rung and backs off
    (``backoff_base * backoff_factor ** attempts``); after
    ``max_retries`` failures the slot is parked on a fresh row and the
    tenant stays quarantined for the operator.

    ``reference_clock`` (optional) arms the clock-skew probe: the offset
    between the snapshot tier's clock and the reference is taken at bind
    time, the server reports ``|drift|`` from it as ``clock_skew``, and the
    ``reclock`` repair re-bases the snapshot clock and re-stamps pending
    arrivals. Metrics: ``recovery.quarantines``, ``recovery.repairs
    {action=...}``, ``recovery.releases``, ``recovery.gave_up``.
    """

    def __init__(self, *, max_retries: int = 3, backoff_base: float = 0.0,
                 backoff_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 reference_clock: Optional[Callable[[], float]] = None):
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_factor = backoff_factor
        self.clock = clock
        self.reference_clock = reference_clock
        self._server = None
        self._pending_events: list = []
        self._episodes: dict[int, _Episode] = {}
        self.history: list[dict] = []
        self._last_healthy = None  # (replica state, resident map or None)
        self._clock_baseline = 0.0

    # -- wiring --------------------------------------------------------------

    def bind(self, server) -> "RecoveryPolicy":
        """Attach to a server (subscribes to its probe monitor)."""
        if server.probe is None:
            raise ValueError("recovery needs the server's probe monitor")
        if self._server is not None:
            raise RuntimeError("recovery policy already bound")
        self._server = server
        server.probe.subscribe(self._pending_events.append)
        if self.reference_clock is not None:
            self._clock_baseline = (
                server.snapshot_server._clock() - self.reference_clock()
            )
        return self

    @property
    def quarantined(self) -> frozenset[int]:
        """Tenants quarantined now (reads from their healthy row)."""
        return frozenset(self._episodes)

    def healthy_row(self, tenant: int):
        """The quarantined tenant's captured healthy row, or None (never
        seen healthy: reads are then served cold)."""
        ep = self._episodes.get(tenant)
        return ep.healthy_row if ep is not None else None

    def measure_skew(self) -> float:
        """|drift| of the snapshot clock from the reference baseline."""
        inner = self._server.snapshot_server
        return abs(
            (inner._clock() - self.reference_clock()) - self._clock_baseline
        )

    # -- the control loop ----------------------------------------------------

    def process(self) -> None:
        """Act on the events recorded since the last call (the server calls
        this right after every probe fold)."""
        if self._server is None:
            return
        # Drain in place: the monitor's subscriber is this list's append.
        events = list(self._pending_events)
        self._pending_events.clear()
        if not events and not self._episodes:
            # An event-free fold: this replica is the last healthy one. A
            # poisoned flush never lands here (it publishes before the
            # fold, so its events arrive in the same call). Without a
            # policy the resident map is the identity (None here).
            policy = self._server.policy
            self._last_healthy = (
                self._server.snapshot.state,
                None if policy is None else dict(policy.resident))
        for ev in events:
            self._ingest(ev)
        self._repair_due()

    def _ingest(self, ev) -> None:
        if ev.probe == "clock_skew":
            self._repair_clock(ev)
            return
        if ev.probe in _GLOBAL_PROBES:
            self.history.append(
                {"event": ev.probe, "action": "ignored", "tick": ev.tick})
            return
        slots = self._diagnose(ev.probe, ev.threshold)
        by_slot = {s: t for t, s in self._server.resident.items()}
        for slot in slots:
            tenant = by_slot.get(slot)
            if tenant is None:
                continue  # an unowned slot: nothing to quarantine
            ep = self._episodes.get(tenant)
            if ep is not None:
                # A recurrence inside an open episode: the failed attempt
                # already escalated the rung.
                ep.actions.append({"event": ev.probe, "redegrade": True})
                continue
            self._quarantine(tenant, slot, ev.probe)

    def _slot_stats(self) -> dict[str, np.ndarray]:
        return {k: _host(v) for k, v in
                slot_stats(self._server.queue.state).items()}

    def _diagnose(self, probe: str, threshold: float) -> list[int]:
        """Slots breaching ``probe``'s threshold, slot by slot."""
        if probe == "ticks_lag":
            lags = self._server._slot_lags()
            return [s for s, lag in enumerate(lags) if lag > threshold]
        stats = self._slot_stats()
        if probe == "finite":
            mask = stats["finite"] < 1.0
        elif probe == "theta.norm_max":
            if "theta.norm" not in stats:
                return []
            mask = stats["theta.norm"] > threshold
        elif probe in ("pmat.asym_rel", "pmat.cond_proxy"):
            if probe not in stats:
                return []
            mask = stats[probe] > threshold
        else:
            return []
        return [int(s) for s in np.nonzero(mask)[0]]

    def _quarantine(self, tenant: int, slot: int, reason: str) -> None:
        server = self._server
        healthy_row = None
        if self._last_healthy is not None:
            hstate, hres = self._last_healthy
            hslot = tenant if hres is None else hres.get(tenant)
            if hslot is not None:
                healthy_row = tenant_row(hstate, hslot)
        start = (0 if reason.startswith("pmat.")
                 and _is_rls_bank(server.queue.state) else 1)
        self._episodes[tenant] = _Episode(
            tenant=tenant, slot=slot, reason=reason, rung=start,
            healthy_row=healthy_row)
        server.metrics.counter("recovery.quarantines").inc()
        _trace.instant("recovery.quarantine", tenant=tenant, slot=slot,
                       reason=reason, start_action=LADDER[start])

    def _repair_due(self) -> None:
        now = self.clock()
        for tenant in list(self._episodes):
            ep = self._episodes.get(tenant)
            if ep is None or ep.gave_up or ep.backoff_until > now:
                continue
            self._attempt(ep)

    # -- repairs -------------------------------------------------------------

    def _attempt(self, ep: _Episode) -> None:
        server = self._server
        action = LADDER[ep.rung]
        if action == "rebuild":
            ok, why = self._check_log(ep)
            if not ok:
                # A failed pre-check is not an attempt: straight to reset,
                # no retry spent, no backoff.
                ep.actions.append({"action": "rebuild",
                                   "outcome": "fallthrough", "reason": why})
                self.history.append({"tenant": ep.tenant, "action": "rebuild",
                                     "outcome": "fallthrough", "reason": why})
                ep.rung = len(LADDER) - 1
                action = LADDER[ep.rung]
        with _trace.span("recovery.repair", tenant=ep.tenant, slot=ep.slot,
                         action=action, attempt=ep.attempts):
            if action == "resymmetrize":
                inner = server.snapshot_server
                inner.queue.state = resymmetrize_tenant(inner.queue.state,
                                                        ep.slot)
                inner.publish()
            elif action == "rebuild":
                self._rebuild(ep)
            else:
                server.reset_tenant(ep.tenant)
        server.metrics.counter("recovery.repairs", action=action).inc()
        verified = self._verify(ep)
        ep.actions.append({"action": action, "verified": verified})
        self.history.append(
            {"tenant": ep.tenant, "action": action, "verified": verified})
        if verified:
            del self._episodes[ep.tenant]
            server.metrics.counter("recovery.releases").inc()
            _trace.instant("recovery.release", tenant=ep.tenant,
                           action=action, attempts=ep.attempts)
            return
        ep.attempts += 1
        if ep.attempts > self.max_retries:
            # Park a fresh row so the bank-wide probes stop firing; the
            # tenant stays quarantined (healthy reads keep flowing).
            server.reset_tenant(ep.tenant)
            ep.gave_up = True
            ep.backoff_until = float("inf")
            server.metrics.counter("recovery.gave_up").inc()
            _trace.instant("recovery.gave_up", tenant=ep.tenant,
                           attempts=ep.attempts)
            return
        ep.rung = min(ep.rung + 1, len(LADDER) - 1)
        ep.backoff_until = self.clock() + self.backoff_base * (
            self.backoff_factor ** ep.attempts)

    def _check_log(self, ep: _Episode) -> tuple[bool, str]:
        """A rebuild may only install the tenant's *whole*, *finite*
        history; anything else resets instead."""
        log = self._server.log
        if log is None or log.size(ep.tenant) == 0:
            return False, "no_log"
        if not log.complete(ep.tenant):
            return False, "incomplete_log"
        xs, ys = log.arrays(ep.tenant)
        if not (np.isfinite(xs).all() and np.isfinite(ys).all()):
            return False, "corrupt_log"
        return True, ""

    def _rebuild(self, ep: _Episode) -> None:
        server = self._server
        inner = server.snapshot_server
        if server.policy is None:
            # A slot-keyed log: evict + readmit is the rebuild, bit for bit
            # the operator's path.
            inner.evict(ep.tenant)
            replayed = inner.readmit(ep.tenant)
        else:
            # Pending arrivals are already in the id-keyed log: drop the
            # slot's backlog and replay the whole history into the slot.
            inner.queue.drop_pending(ep.slot)
            inner._arrival_times[ep.slot].clear()
            xs, ys = server.log.arrays(ep.tenant)
            inner.queue.state = inner._rebuild_fn(inner.queue.state, ep.slot,
                                                  xs, ys)
            inner.publish()
            replayed = len(ys)
        server._expected[ep.slot] = replayed

    def _verify(self, ep: _Episode) -> bool:
        """The repaired slot against the monitor's own thresholds."""
        server = self._server
        thr = server.probe.thresholds
        stats = self._slot_stats()
        s = ep.slot
        if float(stats["finite"][s]) < 1.0:
            return False
        for skey, tkey in (("theta.norm", "theta.norm_max"),
                           ("pmat.asym_rel", "pmat.asym_rel"),
                           ("pmat.cond_proxy", "pmat.cond_proxy")):
            if skey in stats and tkey in thr:
                direction, bound = thr[tkey]
                if direction == "max" and float(stats[skey][s]) > bound:
                    return False
        if "ticks_lag" in thr:
            _, bound = thr["ticks_lag"]
            if server._slot_lags()[s] > bound:
                return False
        return True

    def _repair_clock(self, ev) -> None:
        server = self._server
        inner = server.snapshot_server
        if self.reference_clock is None:  # pragma: no cover - the stat is
            return  # reported only with a reference
        with _trace.span("recovery.repair", action="reclock"):
            ref, base = self.reference_clock, self._clock_baseline
            inner._clock = lambda: ref() + base
            now = inner._clock()
            # The skewed clock stamped wrong arrival ages: re-stamp the
            # pending positions in the trusted domain.
            inner._arrival_times = [
                deque((pos, now) for pos, _ in times)
                for times in inner._arrival_times
            ]
        server.metrics.counter("recovery.repairs", action="reclock").inc()
        self.history.append(
            {"event": "clock_skew", "action": "reclock", "skew": ev.value})


# ---------------------------------------------------------------------------
# Durable checkpoint / restore
# ---------------------------------------------------------------------------


def _ckpt_name(gen: int) -> str:
    return f"gen_{gen:08d}.ckpt"


def _list_generations(directory: str) -> list[tuple[int, str]]:
    """(generation, path) pairs in ``directory``, newest first."""
    out = []
    for name in os.listdir(directory):
        if name.startswith("gen_") and name.endswith(".ckpt"):
            try:
                gen = int(name[4:-5])
            except ValueError:
                continue
            out.append((gen, os.path.join(directory, name)))
    return sorted(out, reverse=True)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _map_leaves(fm) -> list[np.ndarray]:
    """A feature map's tensors in ``repro``'s pytree order: a NamedTuple's
    fields, a ``FeatureMap``'s params."""
    if fm is None:
        return []
    params = getattr(fm, "params", fm)
    return [_host(a) for a in params]


def _log_payload(log) -> Optional[dict]:
    if log is None:
        return None
    return {
        "capacity": log.capacity,
        "tenants": {
            int(t): {
                "entries": [(np.asarray(x), float(y)) for x, y in log._buf[t]],
                "appended": log._appended.get(t, 0),
            }
            for t in log.tenants()
        },
    }


def _load_log(log, payload: Optional[dict]) -> None:
    log.clear()
    if payload is None:
        return
    for t, rec in payload["tenants"].items():
        t = int(t)
        for x, y in rec["entries"]:
            log.append(t, x, y)
        # The overflow counter, so complete() stays true to the history.
        log._appended[t] = int(rec["appended"])


def _config(server) -> dict:
    return {
        "learner": server.learner,
        "slots": server.slots,
        "chunk": server.queue.chunk,
        "hp": dict(server._hp),
    }


def save_checkpoint(server, directory, *, keep: int = 3) -> str:
    """Write one crash-consistent checkpoint generation of ``server``.

    The payload holds what a fresh server built with the same
    ``make_server`` arguments needs to resume bit for bit: the bank
    state's leaves (host numpy, field order), the queue's counters and
    pending buffers, the replica's version and tick, the slot policy's
    state, the replay logs with their overflow counters, the evicted set,
    the expected-ticks ledger and the WAL's high-water mark; the feature
    map's leaves ride along for validation.

    Protocol: serialize -> temp file -> fsync -> ``os.replace`` to
    ``gen_N.ckpt``, then the ``LATEST`` marker the same way; generations
    beyond ``keep`` are removed, oldest first. Returns the path.
    """
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    gens = _list_generations(directory)
    gen = gens[0][0] + 1 if gens else 0
    inner = server.snapshot_server
    queue = inner.queue
    with _trace.span("recovery.checkpoint", generation=gen):
        payload = {
            "format": CKPT_FORMAT,
            "generation": gen,
            "config": _config(server),
            "state": [_host(a) for a in queue.state],
            "feature_map": (_map_leaves(server.feature_map)
                            if server.feature_map is not None else None),
            "queue": {
                "ticks_served": queue.ticks_served,
                "flushes": queue.flushes,
                "arrivals": list(queue.arrivals),
                "pending": [[(np.asarray(x), float(y)) for x, y in q]
                            for q in queue._pending],
            },
            "snapshot": {"version": inner.snapshot.version,
                         "tick": inner.snapshot.tick},
            "policy": (server.policy.state_dict()
                       if server.policy is not None else None),
            "log": _log_payload(server.log),
            "inner_log": (_log_payload(inner.log)
                          if server.policy is not None else None),
            "evicted": sorted(inner._evicted),
            "expected": dict(server._expected),
            "wal_seq": server.wal.seq if server.wal is not None else -1,
        }
        data = pickle.dumps(payload)
        path = os.path.join(directory, _ckpt_name(gen))
        _atomic_write(path, data)
        _atomic_write(os.path.join(directory, "LATEST"),
                      (_ckpt_name(gen) + "\n").encode())
        for _, old_path in gens[max(keep - 1, 0):]:
            os.remove(old_path)
    _telemetry.record_checkpoint(bytes_written=len(data))
    return path


# What a checkpoint may reference: numpy arrays, dtypes and scalars, and
# plain containers. Anything else (a callable above all) is refused.
_SAFE_GLOBALS = {
    "builtins": {"dict", "list", "tuple", "set", "frozenset", "int",
                 "float", "complex", "bool", "str", "bytes", "bytearray",
                 "slice", "range"},
    "numpy": {"ndarray", "dtype"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in _SAFE_GLOBALS.get(module, ()) or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which is not a numpy "
            "or builtin type")


def _load(path: str) -> dict:
    """A generation's payload; raises ``_Unloadable`` for a file that is
    torn, corrupt or not a checkpoint."""
    try:
        with open(path, "rb") as fh:
            payload = _SafeUnpickler(io.BytesIO(fh.read())).load()
    except (OSError, EOFError, pickle.UnpicklingError, ValueError,
            TypeError, IndexError, KeyError, AttributeError) as exc:
        raise _Unloadable(repr(exc)) from exc
    if not isinstance(payload, dict) or payload.get("format") != CKPT_FORMAT:
        fmt = payload.get("format") if isinstance(payload, dict) else None
        raise _Unloadable(f"unrecognized checkpoint format {fmt!r}")
    return payload


class _Unloadable(Exception):
    """A checkpoint file that does not load (skipped by restore)."""


def _validate(payload: dict, server) -> None:
    cfg = payload["config"]
    mine = _config(server)
    for key in ("learner", "chunk", "hp"):
        if cfg[key] != mine[key]:
            raise ValueError(
                f"checkpoint config mismatch on {key!r}: "
                f"saved {cfg[key]!r} != server {mine[key]!r}")
    if payload["feature_map"] is not None:
        fresh = _map_leaves(server.feature_map)
        saved = payload["feature_map"]
        if len(saved) == 2 and len(fresh) == 3 and np.array_equal(
                fresh[2], _host(uniform_trig_scale(fresh[0].shape[1]))):
            # A paper RFF draw (omega, bias): the port serves it as its
            # trig form, whose scale is the uniform sqrt(2/D).
            fresh = fresh[:2]
        if len(fresh) != len(saved) or not all(
                a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
                for a, b in zip(fresh, saved)):
            raise ValueError(
                "checkpoint feature map mismatch: the server's map is not "
                "the saved one (same seed and family needed for a bit for "
                "bit restore)")


def _install(payload: dict, server) -> None:
    from repro_torch.serve.snapshot import StateSnapshot

    inner = server.snapshot_server
    queue = inner.queue
    if server.slots != payload["config"]["slots"]:
        # Bank geometry comes back by resize (policy mode); without a
        # policy the server must be built at the saved size.
        if server.policy is None:
            raise ValueError(
                f"checkpoint has {payload['config']['slots']} slots, "
                f"server has {server.slots}; rebuild at the saved size")
        server.resize(payload["config"]["slots"])
    leaves = []
    for name, like, a in zip(queue.state._fields, queue.state,
                             payload["state"]):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(like.shape) or str(a.dtype) != str(
                like.dtype).removeprefix("torch."):
            raise ValueError(
                f"checkpoint leaf {name!r} is {a.dtype}{list(a.shape)}, the "
                f"server's {like.dtype}{list(like.shape)}")
        leaves.append(torch.from_numpy(a.copy()).to(like.device))
    if len(leaves) != len(queue.state):
        raise ValueError("checkpoint state has the wrong number of leaves")
    state = type(queue.state)(*leaves)
    queue.state = state
    q = payload["queue"]
    queue.ticks_served = int(q["ticks_served"])
    queue.flushes = int(q["flushes"])
    queue.arrivals = [int(a) for a in q["arrivals"]]
    queue._pending = [
        deque((np.asarray(x, queue._dtype), queue._dtype.type(y))
              for x, y in pend)
        for pend in q["pending"]
    ]
    queue._first_pending_at = [None] * queue.num_tenants
    now = inner._clock()
    inner._arrival_times = [deque((i, now) for i in range(len(pend)))
                            for pend in queue._pending]
    inner._snapshot = StateSnapshot(
        state=state, version=int(payload["snapshot"]["version"]),
        tick=int(payload["snapshot"]["tick"]))
    inner._evicted = set(payload["evicted"])
    if server.policy is not None:
        server.policy.load_state(payload["policy"])
        _load_log(server.log, payload["log"])
        if inner.log is not None:
            _load_log(inner.log, payload["inner_log"])
    elif inner.log is not None:
        _load_log(inner.log, payload["log"])
    server._expected = {int(k): int(v)
                        for k, v in payload["expected"].items()}


def restore_checkpoint(server, directory, *, replay_wal: bool = True) -> dict:
    """Restore ``server`` (freshly built with the same ``make_server``
    arguments) from the newest loadable generation in ``directory``.

    Generations are tried newest first: a file that does not load (torn,
    corrupt, not a checkpoint) is skipped with a trace mark, and restore
    raises only when none loads. A config or feature-map mismatch raises
    at once (a caller's error, not corruption); errors while installing
    the leaves on the server's device are never caught. With a WAL and
    ``replay_wal``, every entry after the checkpoint's high-water mark is
    fed through ``submit`` (appends suspended, so replay is idempotent
    across restores). Returns ``{"generation", "replayed", "wal_seq"}``.
    """
    directory = str(directory)
    gens = _list_generations(directory)
    if not gens:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    payload = None
    errors = []
    for _, path in gens:
        try:
            candidate = _load(path)
        except _Unloadable as exc:
            errors.append((path, str(exc)))
            _trace.instant("recovery.restore_skip", path=path,
                           error=str(exc))
            continue
        _validate(candidate, server)
        payload = candidate
        break
    if payload is None:
        raise ValueError(f"no loadable checkpoint in {directory!r}: {errors}")
    with _trace.span("recovery.restore", generation=payload["generation"]):
        _install(payload, server)
        replayed = 0
        if replay_wal and server.wal is not None:
            suffix = server.wal.entries(after=int(payload["wal_seq"]))
            server._wal_suspended = True
            try:
                for rec in suffix:
                    server.submit(rec["t"], rec["x"], rec["y"])
                    _telemetry.record_wal_append(replayed=True)
                    replayed += 1
            finally:
                server._wal_suspended = False
    _telemetry.record_checkpoint(bytes_written=0, restore=True)
    return {
        "generation": payload["generation"],
        "replayed": replayed,
        "wal_seq": int(payload["wal_seq"]),
    }
