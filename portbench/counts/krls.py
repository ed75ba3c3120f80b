"""RFF-KRLS counts (frozen from ``obs/telemetry.py``'s
``krls_chunk_bytes`` / ``predict_read_bytes`` and ``chip_smoke.py``'s
``krls_cost`` and kernel 3 bound, with masked ticks counting nothing).

A live tick of one tenant: ``2 d D`` for the features, ``5 D^2`` for
the paper's update (``2 D^2`` for ``P z``, ``2 D^2`` for the rank-1
downdate, ``D^2`` for the ``1 / beta`` scale; a symmetrization pass is a
choice of the implementation and counts nothing), ``12 D`` for the rest;
bytes: its x (d), y, prediction and error. A tenant with a live tick:
theta (D) and P (D^2) in and out once a block, ``8 D^2 + 8 D`` bytes, so
a dense block moves P's ``8 B D^2`` bytes once. Each block: W, b and the
scale. A read row as in RFF-KLMS."""
from __future__ import annotations

__all__ = ["write", "read"]


def write(cfg: dict, live: int, active: int) -> tuple[float, float]:
    d, dfeat = cfg["input_dim"], cfg["num_features"]
    ops = live * (2 * d * dfeat + 5 * dfeat ** 2 + 12 * dfeat)
    nbytes = 4 * (d * dfeat + 2 * dfeat + 2 * active * (dfeat ** 2 + dfeat)
                  + live * (d + 3))
    return float(ops), float(nbytes)


def read(cfg: dict, rows: int) -> tuple[float, float]:
    d, dfeat, bank = cfg["input_dim"], cfg["num_features"], cfg["bank"]
    ops = rows * (2 * d * dfeat + 5 * dfeat)
    nbytes = 4 * (d * dfeat + 2 * dfeat + bank * dfeat + rows * (d + 1))
    return float(ops), float(nbytes)
