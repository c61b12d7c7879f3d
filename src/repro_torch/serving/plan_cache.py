"""LRU cache of pre-planned matchers.

A ``Matcher`` holds what is planned once per (n, cap, batch) class: the
pinned search depth (which spares each call a device read) and, on a
grid, the block capacity, the bucket capacities and the engine. A serving
process keeps one planned matcher per size class alive and reuses it for
every batch in that class — this module is that cache, with LRU eviction
so a long tail of rare shapes cannot pin unbounded planned state, and
hit/miss/eviction counters so the operator can see whether the class
ladder is actually bucketing traffic (a hit rate near zero means every
request plans anew; see ``service.size_class_for``).

The cache is deliberately generic (`get(key, build)`): it caches whatever
``build`` returns.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Hashable


@dataclasses.dataclass
class CacheStats:
    """Counters for one cache lifetime."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> str:
        return (f"{self.hits} hits / {self.misses} misses "
                f"(rate {self.hit_rate:.2f}), {self.evictions} evictions")


class PlanCache:
    """LRU mapping hashable plan keys -> planned matchers.

    ``get`` returns the cached entry (marking it most-recently-used) or
    calls ``build()`` on a miss, inserting the result and evicting the
    least-recently-used entries beyond ``capacity``. An evicted class that
    returns later is re-planned transparently — correctness never depends
    on residency, only latency does.
    """

    def __init__(self, capacity: int = 32):
        if not isinstance(capacity, int) or capacity < 1:
            raise ValueError(
                f"capacity must be a positive int, got {capacity!r}")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return self._entries[key]
        self.stats.misses += 1
        entry = build()  # build OUTSIDE the eviction step: a throwing
        # build must leave the cache untouched
        self._entries[key] = entry
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        """Resident keys, least- to most-recently used."""
        return list(self._entries.keys())

    def clear(self) -> None:
        self._entries.clear()
