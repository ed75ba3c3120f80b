"""RFF-KRLS (paper §6): B exponentially weighted RLS filters on one
feature map.

A live tick: ``pred = theta . z``, ``e = y - pred``, ``pz = P z``,
``k = pz / (beta + z . pz)``, ``theta += k e``, ``P = (P - k pz^T) /
beta``, as the paper writes it (no symmetrization pass). A masked tick
leaves theta, P and the tick count as they are. A fresh row is ``theta =
0``, ``P = I / lam``."""
from __future__ import annotations

import torch

from portbench.reference.common import features, matmul

__all__ = ["Bank"]

READ_BYTES = 256 << 20


class Bank:
    def __init__(self, cfg: dict, w: torch.Tensor, b: torch.Tensor,
                 dtype=torch.float64, tf32: bool = False):
        self.w, self.b = w.to(dtype), b.to(dtype)
        self.lam, self.beta = float(cfg["lam"]), float(cfg["beta"])
        self.tf32 = tf32
        bank, dfeat = cfg["bank"], w.shape[1]
        dev = w.device
        self.theta = torch.zeros(bank, dfeat, dtype=dtype, device=dev)
        self.eye = torch.eye(dfeat, dtype=dtype, device=dev) / self.lam
        self.pmat = self.eye.expand(bank, dfeat, dfeat).clone()
        self.step = torch.zeros(bank, dtype=torch.long, device=dev)

    def write(self, xs, ys, mask):
        z = features(xs, self.w, self.b, self.tf32)
        ys, mask = ys.to(self.theta.dtype), mask.to(self.theta.dtype)
        preds, errs = [], []
        for t in range(xs.shape[1]):
            zt, live = z[:, t], mask[:, t]
            pred = (self.theta * zt).sum(-1)
            err = ys[:, t] - pred
            pz = matmul(self.pmat, zt[:, :, None], self.tf32)[:, :, 0]
            denom = self.beta + (zt * pz).sum(-1)
            gain = pz * (live / denom)[:, None]
            self.theta = self.theta + gain * err[:, None]
            keep = 1.0 + live * (1.0 / self.beta - 1.0)  # 1 / beta if live
            self.pmat.baddbmm_(gain[:, :, None], pz[:, None, :], alpha=-1.0)
            self.pmat.mul_(keep[:, None, None])
            preds.append(pred)
            errs.append(err)
        self.step = self.step + (mask > 0).sum(1)
        return torch.stack(preds, 1), torch.stack(errs, 1)

    def read(self, xq):
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
        self.pmat[slots] = self.eye
        self.step[slots] = 0

    def leaves(self) -> dict:
        return {"theta": self.theta, "pmat": self.pmat, "step": self.step}
