"""The traffic generator: a seed gives the same pool, every seed the same
set of sizes, and the session schedule agrees with the resets."""
import torch

from portbench.generator import Traffic, make_pool, zipf_rates

TRAFFIC = dict(inflight=2, queries=4, active_share=0.25, zipf_alpha=0.9,
               stream_ticks=32, reset_every=2, noise_std=0.05,
               warmup_rounds=4, pool_sessions=2, pool_read_blocks=3)


def _pool(seed, **kw):
    return make_pool(Traffic.from_dict({**TRAFFIC, **kw}), 16, 4, 5, seed,
                     "cpu")


def test_pool_repeats_exactly_for_a_seed():
    a, b = _pool(2 ** 33 + 7), _pool(2 ** 33 + 7)
    for name in ("xs", "ys", "mask", "xq"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.live == b.live and a.active == b.active
    assert torch.equal(a.schedule.group, b.schedule.group)
    c = _pool(2 ** 33 + 8)
    assert not torch.equal(a.xs, c.xs)


def test_every_seed_has_the_same_sizes_in_another_order():
    sizes = []
    for seed in (1, 2, 3):
        p = _pool(seed)
        s = p.schedule
        per_session = []
        for b in range(16):  # slot b's blocks from its first session start
            phase = int(s.group[b]) * s.reset_every
            m = torch.roll(p.mask[:, b], -phase, dims=0)
            per_session += m.reshape(-1, s.stream_rounds * 4).sum(1).tolist()
        sizes.append(sorted(per_session))
        assert sum(p.live) == int(p.mask.sum())
    assert sizes[0] == sizes[1] == sizes[2]


def test_zipf_rates_mean_and_cap():
    for share in (0.125, 0.5, 1.0):
        r = zipf_rates(1024, 0.9, share)
        assert abs(float(r.mean()) - share) < 1e-9
        assert float(r.max()) <= 1.0 and float(r.min()) > 0
        assert torch.all(r[:-1] >= r[1:])


def test_windows_are_the_last_d_samples():
    p = _pool(5)
    xs = p.xs.permute(1, 0, 2, 3).reshape(16, -1, 5)  # (B, ticks, d)
    # x_{n+1} shifts x_n by one sample, across blocks and the pool's wrap.
    nxt = torch.roll(xs, -1, dims=1)
    assert torch.equal(nxt[:, :, 1:], xs[:, :, :-1])


def test_schedule_matches_the_resets():
    p = _pool(9)
    s = p.schedule
    start = torch.zeros(16, dtype=torch.long)
    for g in range(1, 60):
        grp = s.reset_group(g)
        if grp is not None:
            start[s.slots(grp)] = g
        assert torch.equal(s.session_start(g + 1), start), g
    # Each reset starts B / G sessions; each slot restarts every session.
    assert all(len(s.slots(j)) == 16 // s.groups for j in range(s.groups))
