"""The family counts against hand-worked values, and masked ticks count
nothing."""
import json
from pathlib import Path

import pytest

from portbench import spec
from portbench.generator import Traffic, make_pool

HERE = spec.HERE
PEAK_OPS, PEAK_BW = 67e12, 3.35e12


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _counts(name):
    return spec.load_module(HERE, "counts", name)


def _ms(ops, nbytes):
    return max(ops / PEAK_OPS, nbytes / PEAK_BW) * 1e3


def test_klms_chunk_bound_is_its_operations():
    cfg = _cfg("klms-d128-D2048")
    ops, nbytes = _counts("klms").write(cfg, live=1024 * 16, active=1024)
    assert ops / PEAK_OPS * 1e3 == pytest.approx(0.1317, abs=2e-4)
    assert _ms(ops, nbytes) == pytest.approx(0.1317, abs=2e-4)


def test_krls_chunk_bound_is_its_bytes():
    cfg = _cfg("krls-paper-d5-D300")
    ops, nbytes = _counts("krls").write(cfg, live=1024 * 16, active=1024)
    assert nbytes / PEAK_BW * 1e3 == pytest.approx(0.221, abs=5e-4)
    # 2 d D + 5 D^2 + 12 D a live tick: 16384 * 456,600 operations.
    assert ops == 16384 * (2 * 5 * 300 + 5 * 300 ** 2 + 12 * 300)
    assert ops / PEAK_OPS * 1e3 == pytest.approx(0.11166, abs=1e-5)
    assert _ms(ops, nbytes) == pytest.approx(0.221, abs=5e-4)
    # P read and written once a block: 8 B D^2 bytes of it.
    assert nbytes > 8 * 1024 * 300 ** 2


def test_read_bound():
    cfg = _cfg("klms-d128-D2048")
    ops, nbytes = _counts("klms").read(cfg, rows=1024 * 64)
    assert _ms(ops, nbytes) == pytest.approx(0.523, abs=5e-4)


@pytest.mark.parametrize("family", ["klms", "krls"])
def test_masked_ticks_count_nothing(family):
    cfg = _cfg("klms-d128-D2048" if family == "klms"
               else "krls-paper-d5-D300")
    c = _counts(family)
    assert c.write(cfg, live=0, active=0)[0] == 0
    # A block's count is that of its live ticks and active tenants alone.
    traffic = Traffic(inflight=2, queries=0, active_share=0.125,
                      zipf_alpha=0.9, stream_ticks=64, reset_every=2,
                      noise_std=0.05, warmup_rounds=2, pool_sessions=1,
                      pool_read_blocks=0)
    pool = make_pool(traffic, 32, 8, 5, 3, "cpu")
    for k in range(pool.blocks):
        m = pool.mask[k]
        assert pool.live[k] == int(m.sum())
        assert pool.active[k] == int((m.sum(1) > 0).sum())
    dense = c.write(cfg, live=32 * 8, active=32)
    sparse = c.write(cfg, live=pool.live[0], active=pool.active[0])
    assert sparse[0] < dense[0] and sparse[1] < dense[1]
