"""RFF-KLMS counts (frozen from ``obs/telemetry.py``'s
``klms_chunk_bytes`` / ``predict_read_bytes`` and ``chip_smoke.py``'s
kernel 1 and kernel 3 bounds, with masked ticks counting nothing).

A live tick of one tenant: ``2 d D`` for the projection and ``7 D`` for
the bias, the cosine, the scale, the ``theta . z`` multiply-add and the
update's multiply-add; bytes: its x (d), y, prediction and error. A
tenant with a live tick: theta (D) in and out. Each block: W (d D), b and
the scale (2 D). A read row: ``2 d D + 5 D`` (the update's multiply-add
left out); bytes its x (d) and its prediction, and theta of every tenant
once."""
from __future__ import annotations

__all__ = ["write", "read"]


def write(cfg: dict, live: int, active: int) -> tuple[float, float]:
    d, dfeat = cfg["input_dim"], cfg["num_features"]
    ops = live * (2 * d * dfeat + 7 * dfeat)
    nbytes = 4 * (d * dfeat + 2 * dfeat + 2 * active * dfeat
                  + live * (d + 3))
    return float(ops), float(nbytes)


def read(cfg: dict, rows: int) -> tuple[float, float]:
    d, dfeat, bank = cfg["input_dim"], cfg["num_features"], cfg["bank"]
    ops = rows * (2 * d * dfeat + 5 * dfeat)
    nbytes = 4 * (d * dfeat + 2 * dfeat + bank * dfeat + rows * (d + 1))
    return float(ops), float(nbytes)
