"""The port's tracer: spans and counters on ``solve()``'s path.

Off unless :func:`enable` turns it on. On, every span records its name,
its call, the span that opened it and its start and end on
``time.perf_counter_ns()``, and every counter adds into its call's totals;
both stay in memory until :func:`take` hands them over and clears them. A
span opened while no other is open on its thread starts a call: each
``solve()`` opens the root span ``solve``, so its spans and counters share
one call id (the root span's id).

While a ``torch.profiler`` records, each :func:`span` is also a
``record_function`` annotation ``<annotate><name>`` (``repro_torch::``
unless :func:`enable` is given another prefix): it then stands on the
device trace's clock. A :func:`step` (one round or layer of a loop, run
hundreds of times a call) and a read's span are recorded on the host
alone, so that a profiled call carries no annotation per iteration.

Spans never synchronize the device. A span whose work ends in a read of
the device (a greedy round, a BFS layer) covers that work through the
read, and the read's own ``d2h.<site>`` span (:func:`d2h`, :func:`flag`)
says how long the host was blocked on the card; each such read also adds
1 to the counter ``d2h.reads``. Kernel launches are counted by
``kernels.backend.launch_counts``, not here.

Off, a span costs one test of a module global and returns a shared null
context, a counter one test; nothing is allocated.

    from repro_torch import obs
    obs.enable()
    solve(problem)
    trace = obs.take()
    [root] = trace.calls()
    trace.of([root]).count("mcm.layers")
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

import torch

ANNOTATE = "repro_torch::"

_on = False
_annotate = ANNOTATE
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_profiling = torch._C._autograd._profiler_enabled
_spans: list[tuple] = []  # Span fields, made Spans by take()
_counts: dict[int, dict[str, int]] = {}
_local = threading.local()


class Span(NamedTuple):
    """One closed span."""

    name: str
    call: int  # the id of its call's root span
    id: int
    parent: int  # the id of the span that was open when it opened; 0: a root
    start_ns: int
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Trace:
    """What the tracer recorded between two :func:`take` calls."""

    spans: list[Span]  # in the order they closed
    counts: dict[int, dict[str, int]]  # call id -> counter -> total

    def calls(self, name: str = "solve") -> list[Span]:
        """The root spans named ``name``, in the order they opened."""
        return sorted((s for s in self.spans
                       if s.parent == 0 and s.name == name),
                      key=lambda s: s.start_ns)

    def of(self, roots) -> Trace:
        """The part of the record that belongs to the calls of ``roots``."""
        ids = {r.call for r in roots}
        return Trace([s for s in self.spans if s.call in ids],
                     {c: v for c, v in self.counts.items() if c in ids})

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def count(self, name: str) -> int | None:
        """Counter ``name`` summed over the calls; None where it never
        counted."""
        got = [c[name] for c in self.counts.values() if name in c]
        return sum(got) if got else None


def enable(annotate: str = ANNOTATE) -> None:
    """Turn the tracer on; profiler annotations are named
    ``<annotate><span>``. ``annotate`` has one caller that passes another
    prefix, the benchmark's reader of the program's record
    (``bench/program.py``), whose trace reader keys on its own prefix."""
    global _on, _annotate
    _annotate = annotate
    _on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays until :func:`take`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> Trace:
    """The record so far, which is cleared."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans, _counts = [], {}
    return Trace([Span._make(s) for s in spans], counts)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "annotated", "call", "id", "parent", "start",
                 "mark")

    def __init__(self, name: str, annotated: bool):
        self.name, self.annotated = name, annotated

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = 0, self.id
        stack.append(self)
        self.mark = None
        if self.annotated and _profiling():
            self.mark = torch.autograd.profiler.record_function(
                _annotate + self.name)
            self.mark.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        _stack().pop()
        _spans.append((self.name, self.call, self.id, self.parent,
                       self.start, end))
        return False


def span(name: str):
    """A context manager that records span ``name`` while the tracer is
    on, under a profiler also as an annotation."""
    return _Open(name, True) if _on else _NULL


def step(name: str):
    """A span ``name`` of one iteration of a loop (a greedy round, a BFS
    layer): recorded like :func:`span`, but never a profiler annotation."""
    return _Open(name, False) if _on else _NULL


def _add(name: str, k: int) -> None:
    stack = _stack()
    per = _counts.setdefault(stack[-1].call if stack else 0, {})
    per[name] = per.get(name, 0) + k


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of the open call (0 outside any);
    ``k = 0`` marks the counter as reached."""
    if _on:
        _add(name, k)


def d2h(site: str):
    """Span ``d2h.<site>`` around one read of the device by the host,
    counted in ``d2h.reads``."""
    if not _on:
        return _NULL
    _add("d2h.reads", 1)
    return _Open("d2h." + site, False)


def flag(x, site: str) -> bool:
    """``bool(x)``: one read of the device, in span ``d2h.<site>``."""
    if not _on:
        return bool(x)
    with d2h(site):
        return bool(x)
