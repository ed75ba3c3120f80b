"""RFF-KLMS through ``repro_torch``'s lockstep tier; its inputs, mix and
comparison are the tenant bank's (``portbench/bank.py``)."""
from __future__ import annotations

from portbench.bank import (  # noqa: F401  the family's seam
    FIELDS, PREFIXES, compare, describe, make_inputs, traffic)


def init_state(cfg: dict, fm):
    from repro_torch.core.bank import klms_bank_init

    return klms_bank_init(fm, cfg["bank"])


def hp(cfg: dict) -> dict:
    return {"mu": cfg["mu"]}


def reset_kw(cfg: dict) -> dict:
    return {"learner": "klms"}


def leaves(state) -> dict:
    return {"theta": state.theta, "step": state.step}
