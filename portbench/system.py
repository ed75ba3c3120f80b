"""What the lockstep driver's window drives: the program's lockstep tier
(the system under test), or a stand-in in its place.

A system has ``init() -> state``, ``write(state, xs, ys, mask) -> (state,
predictions, errors)``, ``read(state, xq) -> predictions``, ``reset(state,
slots) -> state`` and ``leaves(state) -> {name: tensor}``.
:class:`ProgramSystem` binds ``repro_torch.serve.make_chunk_step``,
``repro_torch.core.bank.bank_predict_block`` (f32) and
``repro_torch.serve.reset_slots``. :class:`ControlSystem` puts the
family's plain reference there, in float32 with TF32 products: the
control that the comparison has to refuse."""
from __future__ import annotations

import math

import torch

__all__ = ["ProgramSystem", "ControlSystem", "feature_map"]


def feature_map(cfg: dict, w: torch.Tensor, b: torch.Tensor):
    """The program's RFF map on the benchmark's W and b, scale sqrt(2 / D)."""
    from repro_torch.features.base import TrigFeatures, trig_map

    dfeat = cfg["num_features"]
    scale = torch.full((dfeat,), math.sqrt(2.0 / dfeat),
                       dtype=torch.float32, device=w.device)
    return trig_map("rff", TrigFeatures(w, b, scale), deterministic=False)


class ProgramSystem:
    def __init__(self, cell, w: torch.Tensor, b: torch.Tensor):
        from repro_torch.core.bank import bank_predict_block
        from repro_torch.serve import make_chunk_step, reset_slots

        cfg, fam = cell.cfg, cell.family
        self.fm = feature_map(cfg, w, b)
        self.cfg, self.fam = cfg, fam
        self._step = make_chunk_step(cfg["family"], self.fm, **fam.hp(cfg))
        self._predict = bank_predict_block
        self._reset = reset_slots
        self._reset_kw = fam.reset_kw(cfg)

    def init(self):
        return self.fam.init_state(self.cfg, self.fm)

    def write(self, state, xs, ys, mask):
        state, out = self._step(state, xs, ys, mask)
        return state, out.prediction, out.error

    def read(self, state, xq):
        return self._predict(state, xq, self.fm)

    def reset(self, state, slots):
        return self._reset(state, slots, **self._reset_kw)

    def leaves(self, state) -> dict:
        return self.fam.leaves(state)


class ControlSystem:
    """The family's reference in the program's place, computed one step
    below the configurations' float32: float32 with TF32 products."""

    def __init__(self, cell, w: torch.Tensor, b: torch.Tensor):
        self.cell, self.w, self.b = cell, w, b

    def init(self):
        return self.cell.reference.Bank(self.cell.cfg, self.w, self.b,
                                        dtype=torch.float32, tf32=True)

    def write(self, bank, xs, ys, mask):
        pred, err = bank.write(xs, ys, mask)
        return bank, pred, err

    def read(self, bank, xq):
        return bank.read(xq)

    def reset(self, bank, slots):
        bank.reset(slots)
        return bank

    def leaves(self, bank) -> dict:
        return bank.leaves()
