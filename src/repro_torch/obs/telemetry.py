"""Live dispatch telemetry: launch counters and bytes-moved gauges.

Counterpart of ``repro/obs/telemetry.py``: the process-wide registry that
the dispatch layer (``kernels/ops.py``) and the serve tier report into.

* ``kernel.launches{op=...}`` / ``kernel.remainder_launches{op=...}`` —
  kernel launches dispatched from the host, with the sub-chunk structure
  (a (B, T) chunk call at kernel chunk k is ceil(T/k) launches, the last
  one short when k does not divide T). The port has no jit trace, so every
  dispatch is a live launch and ``kernel.traces`` never counts (``repro``
  counts an op reached inside its jitted flush there, once per shape);
* ``kernel.bytes_moved{op=...}`` — gauge: the bytes-moved model of the most
  recent dispatch, from the closed forms below;
* ``host.device_waits{site=...}`` — places where the host blocked on the
  device (``obs.trace.host_wait``, which also opens a ``host.wait`` span);
* ``dispatch.launches{site=queue.flush}``, ``queue.stale_flush``,
  ``wal.appends`` / ``wal.replayed`` and ``checkpoint.saves`` /
  ``checkpoint.restores`` / ``checkpoint.bytes`` from the serve tier.

Everything lands in one :class:`~repro_torch.serve.metrics.MetricsRegistry`,
exported by :func:`snapshot` and embedded by ``Server.observability()``;
:func:`reset` drops it. The registry class is imported lazily so
``repro_torch.obs`` and ``repro_torch.serve`` can instrument each other.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "registry",
    "reset",
    "snapshot",
    "record_dispatch",
    "record_device_wait",
    "record_wal_append",
    "record_checkpoint",
    "klms_chunk_bytes",
    "krls_chunk_bytes",
    "predict_read_bytes",
]

_REG = None


def registry():
    """The process-wide dispatch-telemetry registry (created lazily)."""
    global _REG
    if _REG is None:
        from repro_torch.serve.metrics import MetricsRegistry

        _REG = MetricsRegistry()
    return _REG


def reset() -> None:
    """Drop all dispatch telemetry (test isolation hook)."""
    global _REG
    _REG = None


def snapshot() -> dict:
    """Plain-dict export of the dispatch registry."""
    return registry().snapshot()


# op -> its rendered ``name{op=...}`` keys, so that a dispatch on the hot
# path renders no label string.
_OP_KEYS: dict[str, tuple[str, str, str]] = {}


def record_dispatch(op: str, *, launches: int = 1, remainder: int = 0,
                    bytes_moved: Optional[float] = None) -> None:
    """Record one dispatch-layer call of ``op``: ``launches`` launches, of
    which ``remainder`` run a short last block."""
    keys = _OP_KEYS.get(op)
    if keys is None:
        keys = _OP_KEYS[op] = tuple(
            f"{name}{{op={op}}}" for name in (
                "kernel.launches", "kernel.remainder_launches",
                "kernel.bytes_moved"))
    reg = registry()
    reg.counter(keys[0]).inc(launches)
    if remainder:
        reg.counter(keys[1]).inc(remainder)
    if bytes_moved is not None:
        reg.set_gauge(keys[2], float(bytes_moved))


_WAIT_KEYS: dict[str, str] = {}


def record_device_wait(site: str) -> None:
    """Count one blocking wait of the host on the device at ``site``."""
    key = _WAIT_KEYS.get(site)
    if key is None:
        key = _WAIT_KEYS[site] = f"host.device_waits{{site={site}}}"
    registry().counter(key).inc()


def record_wal_append(*, replayed: bool = False) -> None:
    """Count one write-ahead-log append (``wal.appends``), or one entry
    re-fed through ``submit`` during restore (``wal.replayed``)."""
    reg = registry()
    reg.counter("wal.replayed" if replayed else "wal.appends").inc()


def record_checkpoint(*, bytes_written: int, restore: bool = False) -> None:
    """Count one checkpoint save (or restore) and gauge its size."""
    reg = registry()
    reg.counter("checkpoint.restores" if restore else "checkpoint.saves").inc()
    reg.set_gauge("checkpoint.bytes", float(bytes_written))


# ---------------------------------------------------------------------------
# Bytes-moved closed forms (``repro``'s, shared with its benches).
# ---------------------------------------------------------------------------


def klms_chunk_bytes(bank: int, d: int, dfeat: int, tchunk: int) -> dict:
    """f32 bytes moved per tick by the fused KLMS path at chunk T.

    Per launch: W (d*D) + b (D) fetched once, theta (B*D) read and written
    once, plus per-tick streams x (B*d), y/mu/mask (3B) in and pred/err
    (2B) out.
    """
    per_launch = 4 * (d * dfeat + dfeat + 2 * bank * dfeat)
    per_tick = 4 * (bank * d + 5 * bank)
    return {
        "bytes_per_tick_model": per_launch / tchunk + per_tick,
        "launch_bytes": per_launch,
        "stream_bytes_per_tick": per_tick,
    }


def krls_chunk_bytes(bank: int, d: int, dfeat: int, tchunk: int) -> dict:
    """f32 bytes per tick for fused KRLS at chunk T — P dominates."""
    per_launch = 4 * (
        d * dfeat + dfeat + 2 * bank * dfeat + 2 * bank * dfeat * dfeat
    )
    per_tick = 4 * (bank * d + 5 * bank)
    return {
        "bytes_per_tick_model": per_launch / tchunk + per_tick,
        "launch_bytes": per_launch,
        "stream_bytes_per_tick": per_tick,
    }


def predict_read_bytes(bank: int, d: int, dfeat: int, q: int) -> dict:
    """f32 bytes for Q queries a tenant on the fused read path against a
    per-query adapter that re-fetches W, b and theta for every query."""
    shared = 4 * (d * dfeat + dfeat + bank * dfeat)
    stream = 4 * (bank * d + bank)
    return {
        "adapter_bytes": q * (shared + stream),
        "fused_bytes": shared + q * stream,
        "shared_bytes_per_launch": shared,
        "stream_bytes_per_query": stream,
    }
