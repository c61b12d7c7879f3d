"""Straggler detection: EWMA step-time monitor with z-score flagging.

On a real fleet each host reports its step wall-time; ranks whose EWMA
exceeds ``threshold`` x the fleet median are flagged for (a) input
resharding away from them, (b) eviction and a shrunk grid
(``runtime.elastic``). On one host the monitor also serves a single loop
as a slow-step alarm. Host numpy only."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.0
    warmup: int = 5

    def __post_init__(self):
        self.ewma: dict[int, float] = {}
        self.n: dict[int, int] = {}
        self.flagged: set[int] = set()
        self.history: list[tuple[int, int, float]] = []  # (step, rank, dt)

    def record(self, step: int, dt: float, rank: int = 0):
        prev = self.ewma.get(rank)
        self.ewma[rank] = dt if prev is None else \
            self.alpha * dt + (1 - self.alpha) * prev
        self.n[rank] = self.n.get(rank, 0) + 1
        self.history.append((step, rank, dt))
        self._evaluate()

    def _evaluate(self):
        ready = {r: t for r, t in self.ewma.items() if self.n[r] >= self.warmup}
        if len(ready) < 2:
            return
        med = float(np.median(list(ready.values())))
        self.flagged = {r for r, t in ready.items() if t > self.threshold * med}

    def slow_ranks(self):
        return sorted(self.flagged)

    def slow_steps(self, rank: int = 0):
        """Per-step alarm for a SINGLE rank (cross-rank z-scoring needs >= 2
        ranks; a lone serving loop still wants to know which dispatches
        stalled): steps whose wall time exceeded ``threshold`` x the rank's
        median, once ``warmup`` samples exist."""
        dts = [(s, t) for s, r, t in self.history if r == rank]
        if len(dts) < max(self.warmup, 1):
            return []
        med = float(np.median([t for _, t in dts]))
        return sorted(s for s, t in dts if t > self.threshold * med)
