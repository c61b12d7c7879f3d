"""The comparison that decides a run's ``correct``.

Each checked call's answer from the program is held, lane by lane (one
lane for a single instance, B for a batch), against the plain reference's
answer for the same values (and, on the warm path, for the same seed: the
program's own answer to the previous call, which the program was given).
Two numbers are compared, each with its limit (see PERF.md for the
readings they were set from):

- ``calls_off``: checked calls in which any lane's mates (``mate_row``
  and ``mate_col``), AWAC rounds, perfection or preflight findings differ
  from the reference's in any entry. The program promises the reference's
  answer bit for bit, so the limit is 0.
- ``weight_gap``: the largest relative gap, over the checked lanes, between
  the weight the program reports and the reference's float64 sum of its
  own matched entries.
"""
from __future__ import annotations

import dataclasses

import torch

LIMITS = {"calls_off": 0, "weight_gap": 1e-5}


@dataclasses.dataclass
class Served:
    """What one call returned for one lane, as the caller holds it."""

    mate_row: torch.Tensor  # [n + 1]
    mate_col: torch.Tensor  # [n + 1]
    rounds: int
    perfect: bool
    weight: float
    issues: frozenset


def differs(got: Served, want, want_issues) -> bool:
    return not (torch.equal(got.mate_row.long(), want.mate_row)
                and torch.equal(got.mate_col.long(), want.mate_col)
                and got.rounds == want.rounds
                and got.perfect == want.perfect()
                and got.issues == frozenset(want_issues))


def weight_gap(got: Served, want) -> float:
    ref = want.weight()
    return abs(got.weight - ref) / max(abs(ref), 1e-30)


class Tally:
    """The compared numbers over a run's checked calls and their lanes."""

    def __init__(self):
        self.calls: set[int] = set()
        self.off: set[int] = set()
        self.lanes = 0
        self.lanes_off: dict[int, int] = {}  # lane -> checked calls off
        self.weight_gap = 0.0

    @property
    def checked(self) -> int:
        return len(self.calls)

    @property
    def calls_off(self) -> int:
        return len(self.off)

    @property
    def first_off(self) -> int | None:
        return min(self.off) if self.off else None

    def add(self, call: int, got: Served | None, want, want_issues,
            lane: int = 0) -> None:
        """Hold lane ``lane`` of call ``call``'s answer (None: it never
        came) against the reference's."""
        self.calls.add(call)
        self.lanes += 1
        if got is None or differs(got, want, want_issues):
            self.off.add(call)
            self.lanes_off[lane] = self.lanes_off.get(lane, 0) + 1
        if got is not None:
            self.weight_gap = max(self.weight_gap, weight_gap(got, want))

    def numbers(self) -> dict:
        return {"calls_off": self.calls_off, "weight_gap": self.weight_gap}

    def passed(self) -> bool:
        return self.checked > 0 and all(
            v <= LIMITS[k] for k, v in self.numbers().items())

    def report(self) -> dict:
        """Each number beside its limit, for the result's last key."""
        return {k: {"value": v, "limit": LIMITS[k]}
                for k, v in self.numbers().items()}
