"""The one traffic generator: a cell's input pool and schedule, on the
device, from the seed.

Frozen here so that a change to the program cannot move the yardstick:
the paper's example 2 nonlinear Wiener model (§5.2, eq. 9) and a Zipf
spread of per-stream rates. Everything a traffic mix varies is a number in
its ``traffic/<mix>.json``.

The bank has B slots. Each slot is a channel with its own realization of
eq. 9: ``w0, w1 ~ N(0, I_d)``, a white ``N(0, 1)`` input series ``u`` and
``y_n = w0 . x_n + 0.1 (w1 . x_n)^2 + eta_n``, ``eta ~ N(0, noise_std^2)``,
where ``x_n`` holds the last d samples of ``u`` (so each ``x_n ~ N(0,
I_d)``, as in the paper). A tenant is one session on a slot: it starts
from the fresh row, lasts ``stream_ticks`` bank ticks, and the slot then
starts a new tenant. Sessions start staggered: the slots fall in ``G =
stream_rounds / reset_every`` groups, and group j's sessions start at the
rounds ``g > 0`` with ``g = j * reset_every (mod stream_rounds)``, so one
``reset_slots`` call every ``reset_every`` rounds starts B / G sessions.

A round writes one block ``(B, T, d)`` and, where the mix has queries,
reads one block ``(B, Q, d)`` of i.i.d. ``N(0, I_d)`` queries. The pool
holds ``P = pool_sessions * stream_rounds`` write blocks and ``P_r =
pool_read_blocks`` read blocks; round g takes write block ``g mod P``
and read block ``g mod P_r``, so the pool repeats after ``P`` rounds. The input series is
periodic with the pool, so a window ``x_n`` is the same wherever the pool
wraps.

Each session has a rate: the B values of a Zipf(``zipf_alpha``) spread,
``c / k^alpha`` for ranks k = 1..B, clipped at 1 and scaled so that their
mean is ``active_share``, are dealt to the slots in an order drawn from
the seed, anew for every session of the pool. A session at rate rho has
exactly ``round(rho * stream_ticks)`` live (unmasked) ticks, at places
drawn from the seed. So every seed has the same set of sizes, in another
order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Traffic", "Pool", "zipf_rates", "make_pool", "Schedule"]


@dataclass(frozen=True)
class Traffic:
    """A traffic mix, as its ``traffic/<mix>.json`` states it."""

    inflight: int
    queries: int
    active_share: float
    zipf_alpha: float
    stream_ticks: int
    reset_every: int
    noise_std: float
    warmup_rounds: int
    pool_sessions: int
    pool_read_blocks: int

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        t = cls(**{k: d[k] for k in cls.__dataclass_fields__})
        if min(t.inflight, t.reset_every, t.pool_sessions) < 1 or (
                t.queries and t.pool_read_blocks < 1):
            raise ValueError(f"bad traffic {d}")
        if not 0.0 < t.active_share <= 1.0:
            raise ValueError(f"active_share {t.active_share} not in (0, 1]")
        return t


def zipf_rates(bank: int, alpha: float, mean: float) -> torch.Tensor:
    """The B rates of the spread, highest first (float64, on the CPU):
    ``min(1, c / k^alpha)`` with c set so that the mean is ``mean``."""
    base = torch.arange(1, bank + 1, dtype=torch.float64) ** (-alpha)
    lo, hi = 0.0, float(bank) ** alpha * 2.0 + 1.0
    for _ in range(200):  # bisection on c: the mean rises with c
        c = 0.5 * (lo + hi)
        if torch.clamp(c * base, max=1.0).mean().item() < mean:
            lo = c
        else:
            hi = c
    return torch.clamp(hi * base, max=1.0)


class Schedule:
    """Which slots start a session at which round (pure arithmetic on the
    group of each slot; the same on the host and in the reference)."""

    def __init__(self, group: torch.Tensor, stream_rounds: int,
                 reset_every: int):
        self.group = group.cpu()  # (B,) long, group of each slot
        self.stream_rounds = stream_rounds
        self.reset_every = reset_every
        self.groups = stream_rounds // reset_every

    def reset_group(self, g: int):
        """The group whose sessions start at round g, or None."""
        if g <= 0 or g % self.reset_every:
            return None
        return (g % self.stream_rounds) // self.reset_every

    def slots(self, group: int) -> torch.Tensor:
        return torch.nonzero(self.group == group).flatten()

    def session_start(self, g_end: int) -> torch.Tensor:
        """(B,) the round at which each slot's current session began, for
        a run whose last round is ``g_end - 1``."""
        last = g_end - 1
        phase = self.group * self.reset_every
        start = last - ((last - phase) % self.stream_rounds)
        return torch.where(start > 0, start, torch.zeros_like(start))


@dataclass
class Pool:
    """The inputs of every round, on the device."""

    xs: torch.Tensor      # (P, B, T, d) f32
    ys: torch.Tensor      # (P, B, T) f32
    mask: torch.Tensor    # (P, B, T) f32, 1 = live tick
    xq: torch.Tensor      # (P_r, B, Q, d) f32 (P_r = 0 without queries)
    live: list            # live ticks of each write block (host ints)
    active: list          # tenants with a live tick in each write block
    schedule: Schedule

    @property
    def blocks(self) -> int:
        return self.xs.shape[0]

    @property
    def read_blocks(self) -> int:
        return self.xq.shape[0]


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def make_pool(traffic: Traffic, bank: int, chunk: int, d: int, seed: int,
              device) -> Pool:
    """The pool of a cell: ``bank`` slots, ``chunk`` ticks a write block,
    inputs of width ``d``."""
    t = traffic
    if t.stream_ticks % chunk:
        raise ValueError("stream_ticks must be a multiple of the chunk")
    srounds = t.stream_ticks // chunk
    if srounds % t.reset_every or bank % (srounds // t.reset_every):
        raise ValueError("stream rounds must split into reset groups that "
                         "split the bank")
    sessions = t.pool_sessions
    nblocks = sessions * srounds
    gen = _generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)

    # Staggered session starts: a seeded deal of the slots to the groups.
    groups = srounds // t.reset_every
    deal = torch.randperm(bank, generator=gen, device=device)
    group = deal % groups
    phase = group * t.reset_every

    # Eq. 9 per slot, on a series periodic with the pool.
    length = nblocks * chunk
    u = torch.randn(bank, length, generator=gen, **f32)
    w0 = torch.randn(bank, d, generator=gen, **f32)
    w1 = torch.randn(bank, d, generator=gen, **f32)
    u_ext = torch.cat([u[:, length - d + 1:], u], dim=1) if d > 1 else u
    # x_n = (u_n, u_{n-1}, ..., u_{n-d+1}): windows read newest first.
    win = u_ext.unfold(1, d, 1).flip(-1)  # (B, length, d)
    xs = win.reshape(bank, nblocks, chunk, d).permute(1, 0, 2, 3).contiguous()
    del u_ext, win, u
    lin = torch.einsum("pbtd,bd->pbt", xs, w0)
    quad = torch.einsum("pbtd,bd->pbt", xs, w1)
    eta = t.noise_std * torch.randn(nblocks, bank, chunk, generator=gen, **f32)
    ys = (lin + 0.1 * quad * quad + eta).contiguous()
    del lin, quad, eta

    # Session rates and live ticks, in session time, then rotated so that
    # slot b's sessions start at the blocks = phase_b (mod stream_rounds).
    rates = zipf_rates(bank, t.zipf_alpha, t.active_share).to(device)
    order = torch.argsort(
        torch.rand(sessions, bank, generator=gen, device=device), dim=1)
    n_live = torch.round(rates[order] * t.stream_ticks).long()  # (S, B)
    keys = torch.rand(sessions, bank, t.stream_ticks, generator=gen,
                      device=device)
    rank = torch.argsort(torch.argsort(keys, dim=2), dim=2)
    live = (rank < n_live[:, :, None]).to(torch.float32)  # (S, B, ticks)
    del keys, rank
    in_time = live.reshape(sessions, bank, srounds, chunk).permute(
        1, 0, 2, 3).reshape(bank, nblocks, chunk)
    k = torch.arange(nblocks, device=device)
    src = (k[None, :] - phase[:, None]) % nblocks  # (B, P)
    mask = torch.gather(in_time, 1, src[:, :, None].expand(-1, -1, chunk))
    mask = mask.permute(1, 0, 2).contiguous()
    del in_time, live

    q = t.queries
    if q:
        xq = torch.randn(t.pool_read_blocks, bank, q, d, generator=gen, **f32)
    else:
        xq = torch.empty(0, bank, 0, d, **f32)
    per_block = mask.sum(dim=2)
    live_ticks = per_block.sum(dim=1).long().tolist()
    active = (per_block > 0).sum(dim=1).tolist()
    return Pool(xs=xs, ys=ys, mask=mask, xq=xq, live=live_ticks,
                active=active,
                schedule=Schedule(group.cpu(), srounds, t.reset_every))


def describe(pool: Pool) -> dict:
    """Sizes of a pool, for the run's log."""
    return {
        "write_blocks": pool.blocks,
        "read_blocks": pool.read_blocks,
        "pool_bytes": sum(t.numel() * t.element_size()
                          for t in (pool.xs, pool.ys, pool.mask, pool.xq)),
        "live_share": sum(pool.live) / max(1, pool.mask.numel()),
    }
