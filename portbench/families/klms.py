"""RFF-KLMS through ``repro_torch``'s lockstep tier."""
from __future__ import annotations


def init_state(cfg: dict, fm):
    from repro_torch.core.bank import klms_bank_init

    return klms_bank_init(fm, cfg["bank"])


def hp(cfg: dict) -> dict:
    return {"mu": cfg["mu"]}


def reset_kw(cfg: dict) -> dict:
    return {"learner": "klms"}


def leaves(state) -> dict:
    return {"theta": state.theta, "step": state.step}
