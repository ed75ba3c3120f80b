"""The judgment that decides ``correct``.

The cell's family gives the numbers compared (``families/<family>.py``
``compare``: for the tenant bank ``portbench/bank.py``), once the window
has closed and the program's state is freed; each is held against its
limit in ``limits/<cell>.json``. A number above its limit, or not a
number, is a fail."""
from __future__ import annotations

import math

__all__ = ["judge", "format_checks"]


def judge(numbers: dict, limits: dict) -> bool:
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())


def format_checks(numbers: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
