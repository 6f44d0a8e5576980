"""Slot allocation with pluggable eviction — the machinery generalized out
of serve/cache.py.

A ``SlotMap`` owns ``capacity`` integer slots and maps hashable keys onto
them: the serving cache keys slots by segment content hash, the tiered
store (store/tiered.py) keys each shard's device slots by the global
table row resident in them.  Only bookkeeping lives here — what a slot
physically holds (a device row, a cache entry) is the caller's business,
which is exactly why both tiers can share it.

Eviction policies (the ``--evict-policy`` knob):

  ``lru``          evict the least-recently-used key (insertion/touch
                   order) — the original behavior.
  ``stale-first``  VISAGNN direction (PAPERS.md): rows already carry a
                   refresh age, so score evictions by (age, coldness) —
                   the victim is the key with the OLDEST caller-reported
                   age (``set_age``; keys with no reported age count as
                   stalest), ties broken by LRU coldness.  Fresh-and-hot
                   rows stay resident; stale-and-cold rows leave first.

Either way the policy only picks WHICH row migrates — the migration
itself is bit-preserving, so the training math never sees it
(tests/test_store_props.py).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Iterator, List, Optional, Tuple

POLICIES = ("lru", "stale-first")


class SlotMap:
    """key -> slot map with pinned-key-aware eviction.

    Keys are kept in LRU order (OrderedDict); ``reserve`` picks its
    victim by the configured policy among the keys not in the caller's
    pinned set and reports the displaced (key, slot) pair so the caller
    can migrate/drop whatever the slot held.
    """

    def __init__(self, capacity: int, *, policy: str = "lru"):
        if capacity < 1:
            raise ValueError("slot capacity must be >= 1")
        if policy not in POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r} — "
                             f"expected one of {POLICIES}")
        self.capacity = capacity
        self.policy = policy
        self._slots: "OrderedDict[Hashable, int]" = OrderedDict()
        self._age: Dict[Hashable, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._slots

    def items(self) -> Iterator[Tuple[Hashable, int]]:
        return iter(self._slots.items())

    def get(self, key: Hashable, *, touch: bool = True) -> Optional[int]:
        """Slot of ``key`` or None; ``touch`` refreshes its LRU position."""
        slot = self._slots.get(key)
        if slot is not None and touch:
            self._slots.move_to_end(key)
        return slot

    def touch(self, key: Hashable) -> None:
        self._slots.move_to_end(key)

    def set_age(self, key: Hashable, age: int) -> None:
        """Record ``key``'s refresh age (a monotonic step counter) for the
        stale-first victim scan.  No-op bookkeeping under lru."""
        if key in self._slots:
            self._age[key] = int(age)

    def age_of(self, key: Hashable) -> Optional[int]:
        return self._age.get(key)

    def _victim(self, pinned) -> Optional[Hashable]:
        if self.policy == "lru":
            for key in self._slots:  # iteration order == coldness
                if key not in pinned:
                    return key
            return None
        # stale-first: min reported age wins (unreported == stalest);
        # scanning in LRU order makes the COLDEST of equally-stale keys
        # the victim without a second pass
        best, best_age = None, None
        for key in self._slots:
            if key in pinned:
                continue
            age = self._age.get(key, -1)
            if best is None or age < best_age:
                best, best_age = key, age
        return best

    def reserve(self, key: Hashable, pinned=frozenset(),
                ) -> Tuple[Optional[int], Optional[Tuple[Hashable, int]]]:
        """Allocate a slot for a NEW key (appended at the MRU end).

        Returns ``(slot, evicted)``: ``evicted`` is the displaced
        ``(old_key, slot)`` pair when a live entry had to make room, None
        when a free slot was used.  ``(None, None)`` when the map is full
        and every live key is pinned.
        """
        if key in self._slots:
            raise KeyError(f"key already mapped: {key!r}")
        if self._free:
            slot = self._free.pop()
            self._slots[key] = slot
            return slot, None
        old_key = self._victim(pinned)
        if old_key is None:
            return None, None
        slot = self._slots.pop(old_key)
        self._age.pop(old_key, None)
        self._slots[key] = slot
        return slot, (old_key, slot)

    def release(self, key: Hashable) -> int:
        """Drop ``key`` and return its slot to the free list."""
        slot = self._slots.pop(key)
        self._age.pop(key, None)
        self._free.append(slot)
        return slot

    def clear(self) -> None:
        self._slots.clear()
        self._age.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
