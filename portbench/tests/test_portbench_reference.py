"""The family references against a tiny float64 run of the same
equations, one tenant and one tick at a time in NumPy, and the control's
TF32 rounding."""
import math

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference.common import round_tf32

B, T, D_IN, D = 3, 5, 4, 12


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    w = g.normal(size=(D_IN, D)) / 2.0
    b = g.uniform(0, 2 * math.pi, size=D)
    rounds = [(g.normal(size=(B, T, D_IN)), g.normal(size=(B, T)),
               (g.uniform(size=(B, T)) < 0.6).astype(float))
              for _ in range(4)]
    xq = g.normal(size=(B, 2, D_IN))
    return w, b, rounds, xq


def _z(x, w, b):
    return math.sqrt(2.0 / D) * np.cos(x @ w + b)


def _numpy_run(family, cfg, w, b, rounds, xq, reset_after):
    """Every tenant alone, every tick alone; tenant 1 restarts fresh after
    round ``reset_after``."""
    out = []
    for n in range(B):
        theta, pmat = np.zeros(D), np.eye(D) / cfg.get("lam", 1.0)
        preds = []
        for r, (xs, ys, mask) in enumerate(rounds):
            if n == 1 and r == reset_after + 1:
                theta, pmat = np.zeros(D), np.eye(D) / cfg.get("lam", 1.0)
            for t in range(T):
                z = _z(xs[n, t], w, b)
                pred = theta @ z
                err = ys[n, t] - pred
                preds.append((pred, err))
                if not mask[n, t]:
                    continue
                if family == "klms":
                    theta = theta + cfg["mu"] * err * z
                else:
                    pz = pmat @ z
                    k = pz / (cfg["beta"] + z @ pz)
                    theta = theta + k * err
                    pmat = (pmat - np.outer(k, pz)) / cfg["beta"]
        reads = np.array([theta @ _z(q, w, b) for q in xq[n]])
        out.append((np.array(preds), theta, pmat, reads))
    return out


@pytest.mark.parametrize("family", ["klms", "krls"])
def test_reference_matches_a_tick_by_tick_float64_run(family):
    cfg = {"bank": B, "mu": 0.5, "lam": 1e-2, "beta": 0.99}
    w, b, rounds, xq = _inputs()
    ref = spec.load_module(spec.HERE, "reference", family).Bank(
        cfg, torch.tensor(w), torch.tensor(b), dtype=torch.float64)
    got = []
    for r, (xs, ys, mask) in enumerate(rounds):
        if r == 2:
            ref.reset(torch.tensor([1]))
        p, e = ref.write(torch.tensor(xs), torch.tensor(ys),
                         torch.tensor(mask))
        got.append(torch.stack([p, e], -1).numpy())
    reads = ref.read(torch.tensor(xq)).numpy()
    want = _numpy_run(family, cfg, w, b, rounds, xq, reset_after=1)
    leaves = ref.leaves()
    for n in range(B):
        seq = np.concatenate([g_[n] for g_ in got])
        np.testing.assert_allclose(seq, want[n][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(leaves["theta"][n].numpy(), want[n][1],
                                   rtol=1e-9, atol=1e-12)
        if family == "krls":
            np.testing.assert_allclose(leaves["pmat"][n].numpy(), want[n][2],
                                       rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(reads[n], want[n][3], rtol=1e-9,
                                   atol=1e-12)
    live = np.stack([m for _, _, m in rounds], 1).sum((1, 2))
    live[1] = np.stack([m for _, _, m in rounds[2:]], 1).sum((1, 2))[1]
    assert leaves["step"].tolist() == live.astype(int).tolist()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -12), 3.0e-8, 1e30])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -1.0,
                         3.0e-8, 1e30])
    r = round_tf32(x)
    assert torch.equal(r[:5], want[:5])
    # Ten mantissa bits kept: the low 13 bits are zero, relative error
    # at most 2^-11.
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -11)
