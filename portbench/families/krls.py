"""RFF-KRLS through ``repro_torch``'s lockstep tier; its inputs, mix and
comparison are the tenant bank's (``portbench/bank.py``)."""
from __future__ import annotations

from portbench.bank import (  # noqa: F401  the family's seam
    FIELDS, PREFIXES, compare, describe, make_inputs, traffic)


def init_state(cfg: dict, fm):
    from repro_torch.core.bank import krls_bank_init

    return krls_bank_init(fm, cfg["bank"], cfg["lam"])


def hp(cfg: dict) -> dict:
    return {"lam": cfg["lam"], "beta": cfg["beta"]}


def reset_kw(cfg: dict) -> dict:
    return {"learner": "krls", "lam": cfg["lam"]}


def leaves(state) -> dict:
    return {"theta": state.theta, "pmat": state.pmat, "step": state.step}
