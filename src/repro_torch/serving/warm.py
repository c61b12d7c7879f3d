"""Warm-start seed cache + seed-or-cold fallback.

Warm-start rematching is the streaming analogue of composable-coreset
seeding (Assadi et al., PAPERS.md): a caller's previous matching is a
near-perfect structure for its next, slightly-perturbed instance, so the
solve skips greedy + MCM and runs seed repair + bounded MCM top-up + AWAC
instead (``core.batch.warm_mates_batched`` via
``solve(..., warm_start=)``). This module holds the serving side of that:

  - :class:`WarmStartCache` — per-shard LRU of the last mate arrays per
    request key, kept on the host (numpy) at *size-class* padding so a
    seed drops straight into the next batch for the same class;
  - :func:`solve_with_seed` — call a matcher with a seed when one exists,
    falling back to the cold path (bit-identically — the cold call is the
    exact call an unseeded request would make) when the facade rejects the
    seed's shape as stale.

Seed *values* are never trusted anywhere: the engine-side repair unmatches
every pair that is stale against the current edge list, so a garbage seed
costs a wasted repair pass, never a wrong matching.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np


@dataclasses.dataclass
class WarmStats:
    """Seed-cache outcome counters."""

    served: int = 0  # lookups that returned a usable seed
    stale: int = 0  # entry existed but for a different size class
    absent: int = 0  # no entry for the key

    @property
    def hit_rate(self) -> float:
        total = self.served + self.stale + self.absent
        return self.served / total if total else 0.0


class WarmStartCache:
    """LRU of ``key -> (n_class, mate_row, mate_col)``.

    Mates are stored at the size-class padding ([n_class + 1], sentinel
    n_class) exactly as the batched engine emitted them, so ``seed_for``
    can hand them back into a same-class batch with zero reshaping. A
    lookup for a different ``n_class`` is *stale* (the caller's problem
    changed size class) and returns None — the facade would reject the
    shape anyway; staleness is decided here so the dispatcher can route
    the request down the cold lane up front.
    """

    def __init__(self, capacity: int = 4096):
        if not isinstance(capacity, int) or capacity < 1:
            raise ValueError(
                f"capacity must be a positive int, got {capacity!r}")
        self.capacity = capacity
        self.stats = WarmStats()
        self._entries: OrderedDict[str, tuple] = OrderedDict()

    def put(self, key: str, n_class: int, mate_row, mate_col) -> None:
        mr = np.array(mate_row, dtype=np.int32, copy=True)
        mc = np.array(mate_col, dtype=np.int32, copy=True)
        if mr.shape != (n_class + 1,) or mc.shape != (n_class + 1,):
            raise ValueError(
                f"seed mates must be [n_class + 1] = [{n_class + 1}], got "
                f"{mr.shape}/{mc.shape}")
        self._entries[key] = (int(n_class), mr, mc)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def seed_for(self, key: str,
                 n_class: int) -> tuple[np.ndarray, np.ndarray] | None:
        entry = self._entries.get(key)
        if entry is None:
            self.stats.absent += 1
            return None
        if entry[0] != n_class:
            self.stats.stale += 1
            return None
        self._entries.move_to_end(key)
        self.stats.served += 1
        return entry[1], entry[2]

    def __len__(self) -> int:
        return len(self._entries)


def identity_mates(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The diagonal matching (column j matched to row j) at padding n —
    the natural seed for the identity filler instances that pad a warm
    batch: a perfect AWAC fixed point, so fillers converge in one
    verification round."""
    eye = np.arange(n + 1, dtype=np.int32)
    return eye, eye.copy()


def solve_with_seed(matcher, problem, seed):
    """``matcher(problem, warm_start=seed)`` with a cold fallback.

    Returns ``(result, served_warm)``. A seed the facade rejects
    (ValueError: stale shape from a different n/batch; TypeError: not a
    mates-like object) falls back to the exact cold call an unseeded
    request would make — bit-identical to never having had a seed. Errors
    from the solve itself propagate: only *seed admission* is recoverable
    here.
    """
    if seed is not None:
        try:
            return matcher(problem, warm_start=seed), True
        except (TypeError, ValueError):
            pass
    return matcher(problem), False
