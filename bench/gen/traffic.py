"""The one generator of every traffic mix: a mix is a JSON file of
parameters under ``bench/traffic/``, read here.

Keys of a mix:

- ``values``: ``"fresh"`` (each call's values drawn anew from the seed and
  the call's index) or ``"perturbed"`` (each call's values the previous
  call's, jittered by ``jitter``); call 0 is always fresh.
- ``jitter``: the relative weight jitter of ``"perturbed"``.
- ``warm_start``: each call after the first passes the previous call's
  result to ``solve(..., warm_start=)``.
- ``warmup_calls``: calls made in set-up, before the window, so that
  every kind of call the mix makes has run once.

Every lane of a configuration (``bench/gen/pattern.py::make_lanes``) follows
the mix on its own values, drawn from the lane's own seed.

One caller calls in a closed loop: the next call starts when the previous
one has returned and its result has reached the caller.
"""
from __future__ import annotations

import dataclasses

import torch

from bench.gen import values
from bench.gen.pattern import Pattern

VALUES = ("fresh", "perturbed")


@dataclasses.dataclass(frozen=True)
class Mix:
    values: str
    warm_start: bool
    warmup_calls: int
    jitter: float = 0.0

    def __post_init__(self):
        if self.values not in VALUES:
            raise ValueError(f"unknown values rule {self.values!r}: "
                             f"expected one of {VALUES}")
        if self.warmup_calls < 1:
            raise ValueError("a mix warms up with one call or more")

    @classmethod
    def from_json(cls, spec: dict) -> "Mix":
        return cls(values=spec["values"], warm_start=bool(spec["warm_start"]),
                   warmup_calls=int(spec["warmup_calls"]),
                   jitter=float(spec.get("jitter", 0.0)))


class Stream:
    """The values of calls 0, 1, 2, ... of one run, made in order: one
    [cap] tensor a lane."""

    def __init__(self, mix: Mix, lanes: list[Pattern]):
        self.mix, self.lanes = mix, lanes
        self.call = 0
        self.prev: list[torch.Tensor] | None = None

    def next(self) -> list[torch.Tensor]:
        """The values of the next call, lane by lane."""
        k = self.call
        if self.mix.values == "fresh" or k == 0:
            vals = [values.fresh(p, p.seed, k) for p in self.lanes]
        else:
            vals = [values.perturbed(p, prev, self.mix.jitter, p.seed, k)
                    for p, prev in zip(self.lanes, self.prev)]
        self.prev = vals if self.mix.values == "perturbed" else None
        self.call += 1
        return vals

    def skip(self) -> None:
        """Pass the next call by: its values are made only where a later
        call's follow from them (perturbed)."""
        if self.mix.values == "perturbed":
            self.next()
        else:
            self.call += 1

    def warm(self, call: int) -> bool:
        """Whether call ``call`` warm-starts."""
        return self.mix.warm_start and call > 0
