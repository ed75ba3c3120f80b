"""RFF-KRLS through ``repro_torch``'s lockstep tier."""
from __future__ import annotations


def init_state(cfg: dict, fm):
    from repro_torch.core.bank import krls_bank_init

    return krls_bank_init(fm, cfg["bank"], cfg["lam"])


def hp(cfg: dict) -> dict:
    return {"lam": cfg["lam"], "beta": cfg["beta"]}


def reset_kw(cfg: dict) -> dict:
    return {"learner": "krls", "lam": cfg["lam"]}


def leaves(state) -> dict:
    return {"theta": state.theta, "pmat": state.pmat, "step": state.step}
