"""RFF-KLMS (paper §4): B independent filters on one feature map.

A live tick: ``pred = theta . z(x)``, ``e = y - pred``, ``theta += mu e
z(x)``. A masked tick leaves theta and the tick count as they are (its
prediction and error are not compared). A fresh row is ``theta = 0``."""
from __future__ import annotations

import torch

from portbench.reference.common import features

__all__ = ["Bank"]

READ_BYTES = 256 << 20  # feature rows a read holds at once


class Bank:
    def __init__(self, cfg: dict, w: torch.Tensor, b: torch.Tensor,
                 dtype=torch.float64, tf32: bool = False):
        self.w, self.b = w.to(dtype), b.to(dtype)
        self.mu = float(cfg["mu"])
        self.tf32 = tf32
        bank, dfeat = cfg["bank"], w.shape[1]
        self.theta = torch.zeros(bank, dfeat, dtype=dtype, device=w.device)
        self.step = torch.zeros(bank, dtype=torch.long, device=w.device)

    def write(self, xs, ys, mask):
        """``xs (B, T, d)``, ``ys (B, T)``, ``mask (B, T)`` -> prior
        predictions and errors ``(B, T)``."""
        z = features(xs, self.w, self.b, self.tf32)
        ys, mask = ys.to(self.theta.dtype), mask.to(self.theta.dtype)
        preds, errs = [], []
        for t in range(xs.shape[1]):
            pred = (self.theta * z[:, t]).sum(-1)
            err = ys[:, t] - pred
            self.theta = self.theta + (self.mu * err * mask[:, t])[:, None] \
                * z[:, t]
            preds.append(pred)
            errs.append(err)
        self.step = self.step + (mask > 0).sum(1)
        return torch.stack(preds, 1), torch.stack(errs, 1)

    def read(self, xq):
        """``xq (B, Q, d)`` -> predictions ``(B, Q)``."""
        bank, q, _ = xq.shape
        per = max(1, READ_BYTES // max(1, q * self.w.shape[1]
                                       * self.w.element_size()))
        out = []
        for lo in range(0, bank, per):
            z = features(xq[lo:lo + per], self.w, self.b, self.tf32)
            out.append(torch.einsum("bqk,bk->bq", z, self.theta[lo:lo + per]))
        return torch.cat(out)

    def reset(self, slots):
        self.theta[slots] = 0
        self.step[slots] = 0

    def leaves(self) -> dict:
        return {"theta": self.theta, "step": self.step}
