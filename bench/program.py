"""The program's own record of a traced run, for the per-layer metrics
that read it: the spans and counters that ``repro_torch.obs`` keeps
inside ``solve()``.

A reader of such a metric calls :func:`arm` when it is loaded. The
harness loads the per-layer readers for a traced run alone, before the
run's set-up calls, so the tracer is on from the process's first
``solve()`` to the window's end and off in every untraced run. :func:`arm`
turns it on only where the loading comes from the harness's run of a
traced cell (``harness.run_cell`` with ``traced`` true, found on the call
stack): loading a reader anywhere else, as a test that only checks the
readers are there does, leaves the tracer off. It is armed only where a
card is present (:func:`wanted`). The program's spans are profiler
annotations under the benchmark's own prefix,
``bench::repro_torch.<span>``, so that ``tracing.read`` takes them for
host spans (and not for device rows) and charges each idle gap to the
innermost span, the program's where one is open; the ``repro_torch.``
part keeps them apart from the wrappers' spans of the same word.

The first reader to read takes the record and turns the tracer off; the
others read what it took. The record is split by call: the program's
``solve`` root spans in the order they opened, the last
``run.attempted`` of them the window's calls, the ones before them the
set-up's. Against a program without the tracer, and in a run it was not
armed for, every reader reads nothing.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from bench import harness, tracing

try:
    from repro_torch import obs
except ImportError:  # a program without the tracer
    obs = None

ANNOTATE = tracing.PREFIX + "repro_torch."

_armed = False
_taken: tuple | None = None  # (run, Split) of the last run read


@dataclasses.dataclass
class Split:
    setup: object  # obs.Trace of the set-up calls
    window: object  # obs.Trace of the window's calls
    calls: int  # the window's calls


def wanted() -> bool:
    """Whether a traced run arms the tracer: on a card only. The gate exists
    for one test alone, ``bench/test_bench_faults.py``'s traced run on the
    CPU, which holds the run's metric set to the wrappers' metrics; once
    that test lists the program's metrics too, it can go."""
    return torch.cuda.is_available()


def _loaded_by_traced_run() -> bool:
    """Whether the harness's run of a traced cell is on the call stack."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is harness.run_cell.__code__:
            return bool(frame.f_locals.get("traced"))
        frame = frame.f_back
    return False


def arm() -> None:
    """Turn the program's tracer on, its record cleared, where a traced run
    of the harness loads the reader (see above)."""
    global _armed
    if obs is None or not wanted() or not _loaded_by_traced_run():
        return
    obs.enable(annotate=ANNOTATE)
    obs.take()
    _armed = True


def split(run) -> Split | None:
    """``run``'s record, taken at the first read; None where nothing was
    armed or no call was made."""
    global _armed, _taken
    if _taken is not None and _taken[0] is run:
        return _taken[1]
    if not _armed:
        return None
    _armed = False
    obs.disable()
    trace = obs.take()
    roots = trace.calls("solve")
    k = max(len(roots) - run.attempted, 0)
    got = Split(trace.of(roots[:k]), trace.of(roots[k:]), len(roots) - k) \
        if roots else None
    _taken = (run, got)
    return got


def span_ms(run, name: str) -> float | None:
    """Milliseconds of span ``name`` per window call."""
    s = split(run)
    xs = s.window.named(name) if s and s.calls else []
    return sum(x.ns for x in xs) / 1e6 / s.calls if xs else None


def mean_ms(run, name: str) -> float | None:
    """Mean milliseconds of one span ``name`` in the window."""
    s = split(run)
    xs = s.window.named(name) if s else []
    return sum(x.ns for x in xs) / 1e6 / len(xs) if xs else None


def per_call(run, counter: str) -> float | None:
    """Counter ``counter`` per window call."""
    s = split(run)
    total = s.window.count(counter) if s and s.calls else None
    return None if total is None else total / s.calls


def wait_ms(run) -> float | None:
    """Milliseconds per window call in the program's ``d2h.*`` spans: the
    host blocked on reads of the card."""
    s = split(run)
    xs = [x for x in s.window.spans if x.name.startswith("d2h.")] \
        if s and s.calls else []
    return sum(x.ns for x in xs) / 1e6 / s.calls if xs else None


def first_ms(run) -> float | None:
    """Milliseconds of the process's first ``solve()``: the set-up's first
    root span."""
    s = split(run)
    roots = s.setup.calls("solve") if s else []
    return roots[0].ns / 1e6 if roots else None
