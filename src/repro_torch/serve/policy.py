"""Slot-lifecycle policy: the bank as a cache of hot tenants.

Counterpart of ``repro/serve/policy.py``, copied logic for logic (tie
breaks included): pure host bookkeeping, no tensor code. The facade
(``serve/api.py``) asks it which slot serves a tenant and whom to evict to
admit one, and moves the state itself through ``core.bank``'s row
primitives, so the policy can choose a row but never corrupt one.

Three eviction scores (lower = colder = evicted first):

* ``lru``: the logical clock of the tenant's last touch;
* ``lfu``: the lifetime touch count (kept across evictions);
* ``cost``: recency ``1 / (1 + clock - last_touch)`` times a rebuild-cost
  estimate from ``cost_fn`` (the facade's replay-log length times the
  family's cost a tick).

Admission: when the bank is full a new tenant is admitted only if the
coldest incumbent scores strictly below it (ties keep the incumbent), so
under ``lfu`` and ``cost`` a burst of one-off tail tenants does not flush
the hot set; under ``lru`` a fresh touch always wins. ``suggest_size``
proposes power-of-two grow and shrink targets from occupancy and recent
rejects.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

__all__ = ["AdmitDecision", "SlotPolicy", "SCORERS"]


class AdmitDecision(NamedTuple):
    """Outcome of one admission request.

    ``action`` is one of ``"hit"`` (already resident), ``"admit"`` (placed
    in a free slot), ``"evict"`` (placed in ``slot`` after evicting
    ``victim``), or ``"reject"`` (bank full and no incumbent scored below
    the candidate — the arrival should be logged, not trained).
    """

    action: str
    slot: Optional[int] = None
    victim: Optional[int] = None


def _lru_score(policy: "SlotPolicy", tenant: int) -> float:
    return float(policy.last_touch.get(tenant, 0))


def _lfu_score(policy: "SlotPolicy", tenant: int) -> float:
    return float(policy.touches.get(tenant, 0))


def _cost_score(policy: "SlotPolicy", tenant: int) -> float:
    recency = 1.0 / (1.0 + policy.clock - policy.last_touch.get(tenant, 0))
    cost = policy.cost_fn(tenant) if policy.cost_fn is not None else 1.0
    return recency * cost


SCORERS: dict[str, Callable[["SlotPolicy", int], float]] = {
    "lru": _lru_score,
    "lfu": _lfu_score,
    "cost": _cost_score,
}


class SlotPolicy:
    """Decide which tenants occupy the bank's ``slots`` slots.

    Args:
      slots: number of bank slots currently under management.
      scorer: ``"lru"`` / ``"lfu"`` / ``"cost"`` or a callable
        ``(policy, tenant) -> float`` (lower = evicted first).
      cost_fn: ``tenant -> float`` rebuild-cost estimate consumed by the
        ``cost`` scorer (the facade wires replay-log length x family
        cost). Ignored by the other scorers.
      min_slots / max_slots: pow2 bounds for ``suggest_size``.
      grow_rejects: admission rejects since the last resize that trigger a
        grow suggestion.
      shrink_occupancy: occupancy fraction at or below which a shrink (one
        pow2 step) is suggested.

    Determinism contract: victim selection orders incumbents by
    ``(score, last_touch, tenant)`` — ties on score fall to the
    least-recently-touched, then the smallest tenant id — and free slots
    are handed out lowest-index first, so identical request streams
    produce identical placements (unit-tested).
    """

    def __init__(
        self,
        slots: int,
        scorer: Union[str, Callable] = "lru",
        *,
        cost_fn: Optional[Callable[[int], float]] = None,
        min_slots: int = 1,
        max_slots: int = 1 << 20,
        grow_rejects: int = 8,
        shrink_occupancy: float = 0.25,
    ):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if isinstance(scorer, str):
            if scorer not in SCORERS:
                raise ValueError(
                    f"unknown scorer {scorer!r}; pick from {sorted(SCORERS)}"
                )
            self.scorer_name = scorer
            self._scorer = SCORERS[scorer]
        else:
            self.scorer_name = getattr(scorer, "__name__", "custom")
            self._scorer = scorer
        self.slots = slots
        self.cost_fn = cost_fn
        self.min_slots = min_slots
        self.max_slots = max_slots
        self.grow_rejects = grow_rejects
        self.shrink_occupancy = shrink_occupancy
        self.clock = 0
        self.last_touch: dict[int, int] = {}
        self.touches: dict[int, int] = {}
        self._resident: dict[int, int] = {}
        self._free: list[int] = list(range(slots - 1, -1, -1))  # pop() -> 0
        self.rejects_since_resize = 0

    # -- observation --------------------------------------------------------

    def touch(self, tenant: int) -> None:
        """Record one request for ``tenant`` (advances the logical clock)."""
        self.clock += 1
        self.last_touch[tenant] = self.clock
        self.touches[tenant] = self.touches.get(tenant, 0) + 1

    def lookup(self, tenant: int) -> Optional[int]:
        """The slot serving ``tenant``, or None when not resident."""
        return self._resident.get(tenant)

    @property
    def resident(self) -> dict[int, int]:
        """Snapshot of the tenant -> slot map."""
        return dict(self._resident)

    @property
    def occupancy(self) -> int:
        return len(self._resident)

    def score(self, tenant: int) -> float:
        """Eviction score (lower = colder = evicted first)."""
        return self._scorer(self, tenant)

    def _key(self, tenant: int):
        return (self.score(tenant), self.last_touch.get(tenant, 0), tenant)

    def victim(self) -> Optional[int]:
        """The incumbent the policy would evict next (None if bank empty)."""
        if not self._resident:
            return None
        return min(self._resident, key=self._key)

    # -- placement ----------------------------------------------------------

    def admit(self, tenant: int, force: bool = False) -> AdmitDecision:
        """Place ``tenant`` in a slot, evicting or rejecting as scored.

        Mutates the resident map according to the returned decision — the
        caller performs the matching bank-state work (park the victim's
        slot, rebuild the admitted tenant from its log). ``force=True``
        bypasses the admission floor (operator-initiated readmit).
        """
        slot = self._resident.get(tenant)
        if slot is not None:
            return AdmitDecision("hit", slot=slot)
        if self._free:
            slot = self._free.pop()
            self._resident[tenant] = slot
            return AdmitDecision("admit", slot=slot)
        victim = self.victim()
        # The incumbent floor: the coldest incumbent must score strictly
        # below the candidate; ties keep the incumbent.
        if not force and self.score(victim) >= self.score(tenant):
            self.rejects_since_resize += 1
            return AdmitDecision("reject")
        slot = self._resident.pop(victim)
        self._resident[tenant] = slot
        return AdmitDecision("evict", slot=slot, victim=victim)

    def release(self, tenant: int) -> Optional[int]:
        """Voluntarily evict ``tenant``; returns the freed slot (or None)."""
        slot = self._resident.pop(tenant, None)
        if slot is not None:
            self._free.append(slot)
            self._free.sort(reverse=True)  # keep lowest-index-first handout
        return slot

    def move(self, tenant: int, new_slot: int) -> None:
        """Re-pin a resident tenant to another slot (compaction move)."""
        if tenant not in self._resident:
            raise KeyError(f"tenant {tenant} is not resident")
        self._resident[tenant] = new_slot

    # -- durability ---------------------------------------------------------

    def state_dict(self) -> dict:
        """Plain-dict export of the policy's mutable state (checkpointing).

        Covers everything admission decisions depend on — logical clock,
        touch history, residency, free list, reject pressure — so a
        restored policy makes the same decisions the live one would have.
        ``cost_fn`` is a live callable and is NOT serialized; the facade
        re-wires it at restore.
        """
        return {
            "slots": self.slots,
            "scorer": self.scorer_name,
            "clock": self.clock,
            "last_touch": dict(self.last_touch),
            "touches": dict(self.touches),
            "resident": dict(self._resident),
            "free": list(self._free),
            "rejects_since_resize": self.rejects_since_resize,
        }

    def load_state(self, d: dict) -> None:
        """Restore the mutable state exported by :meth:`state_dict`.

        The receiving policy must already be built with the same scorer
        and structural knobs; slot count is adopted from the snapshot.
        """
        if d["scorer"] != self.scorer_name:
            raise ValueError(
                f"checkpoint scorer {d['scorer']!r} != policy scorer "
                f"{self.scorer_name!r}"
            )
        self.slots = int(d["slots"])
        self.clock = int(d["clock"])
        self.last_touch = {int(k): int(v) for k, v in d["last_touch"].items()}
        self.touches = {int(k): int(v) for k, v in d["touches"].items()}
        self._resident = {int(k): int(v) for k, v in d["resident"].items()}
        self._free = [int(s) for s in d["free"]]
        self.rejects_since_resize = int(d["rejects_since_resize"])

    # -- capacity -----------------------------------------------------------

    def suggest_size(self) -> int:
        """Pow2 slot-count suggestion from occupancy and reject pressure.

        Grow one step when the bank is full and ``grow_rejects`` arrivals
        were rejected since the last resize; shrink one step when
        occupancy is at or below ``shrink_occupancy``. Otherwise the
        current size. The caller decides whether to apply it (and resets
        the reject counter via :meth:`set_slots`).
        """
        if (
            not self._free
            and self.rejects_since_resize >= self.grow_rejects
            and self.slots * 2 <= self.max_slots
        ):
            return self.slots * 2
        if (
            self.slots > self.min_slots
            and self.occupancy <= self.shrink_occupancy * self.slots
        ):
            return max(self.min_slots, self.slots // 2)
        return self.slots

    def set_slots(self, slots: int) -> None:
        """Adopt a new slot count after the caller migrated the bank.

        Every resident slot index must already be < ``slots`` (the facade
        compacts rows first); the free list is rebuilt from the gap.
        """
        used = set(self._resident.values())
        if any(s >= slots for s in used):
            raise ValueError(
                f"resident slots {sorted(used)} do not fit in {slots}"
            )
        self.slots = slots
        self._free = sorted((s for s in range(slots) if s not in used),
                            reverse=True)
        self.rejects_since_resize = 0
