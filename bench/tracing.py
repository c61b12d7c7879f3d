"""The traced run's instruments: host spans around the program's layers
and the reading of the profiler's device trace.

Spans come from the benchmark's own code. A metric reader under
``bench/metrics/`` names the program functions its span wraps
(``WRAPS``, as (module, attribute) pairs, which ``solve()`` looks up by
name when it runs); while the traced window runs, each is replaced by a
wrapper that syncs the device, opens a profiler annotation
``bench::<span>``, calls the function, syncs again and records the host
seconds. A function that is no longer there is left alone, and its span
stays empty, so its metric reads nothing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import time

import torch

PREFIX = "bench::"
NAME_CHARS = 160


class Spans:
    """Host seconds of each span, and the wrappers that record them."""

    def __init__(self, device: torch.device):
        self.seconds: dict[str, list[float]] = collections.defaultdict(list)
        self.sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda: None)
        self._undo: list[tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, module: str, attr: str) -> bool:
        """Record span ``name`` around ``module.attr`` until ``restore``.
        False where the function is not there."""
        try:
            mod = importlib.import_module(module)
        except ImportError:
            return False
        fn = getattr(mod, attr, None)
        if not callable(fn):
            return False

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        self._undo.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
        return True

    def restore(self) -> None:
        while self._undo:
            mod, attr, fn = self._undo.pop()
            setattr(mod, attr, fn)


@dataclasses.dataclass
class DeviceTrace:
    """What the profiler saw of the device over the traced window."""

    window_s: float
    busy_s: float
    rows: dict[str, tuple[int, float]]  # name -> (launches, seconds)
    gaps: dict[str, float]  # host span open during idle time -> seconds

    def seconds_of(self, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(s for k, (_, s) in self.rows.items() if needle in k)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.rows.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:NAME_CHARS], s] for k, (_, s) in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _union(intervals):
    """Merged, sorted, non-overlapping (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labels(mids, spans):
    """For each of the ascending times ``mids``, the innermost host span
    open at it (``spans`` nest and are sorted by start), by one sweep."""
    out, stack, i = [], [], 0
    for mid in mids:
        while i < len(spans) and spans[i][1] <= mid:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out.append(stack[-1][0] if stack else "between calls")
    return out


def read(prof, window: str = "window") -> DeviceTrace:
    """The device's activity inside the annotation ``bench::<window>``,
    from the raw events of a finished ``torch.profiler.profile`` (summing
    them directly: ``key_averages()`` builds a Python object per event).
    Device rows are kernels, copies and fills; idle time is the part of
    the window that no device operation covers, each gap charged to the
    innermost host span open at its midpoint."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX):
            if e.device_type() != cuda:
                spans.append((name[len(PREFIX):], e.start_ns(), e.end_ns()))
            continue
        if e.device_type() != cuda or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        dev.append((name, e.start_ns(), e.end_ns()))
    spans.sort(key=lambda t: (t[1], -t[2]))  # outer first on a tie
    win = [(s, e) for name, s, e in spans if name == window]
    if not win:
        raise RuntimeError(f"the trace holds no {PREFIX}{window} annotation")
    ws, we = win[0]
    inner = [t for t in spans if t[0] != window]
    rows: dict[str, list] = {}
    clipped = []
    for name, s, e in dev:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        r = rows.setdefault(name, [0, 0.0])
        r[0] += 1
        r[1] += (e - s) / 1e9
        clipped.append((s, e))
    busy = _union(clipped)
    idle, cursor = [], ws
    for s, e in busy + [[we, we]]:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    gaps: dict[str, float] = collections.defaultdict(float)
    for (s, e), name in zip(idle, _labels([(s + e) // 2 for s, e in idle],
                                          inner)):
        gaps[name] += (e - s) / 1e9
    return DeviceTrace(window_s=(we - ws) / 1e9,
                       busy_s=sum(e - s for s, e in busy) / 1e9,
                       rows={k: (c, s) for k, (c, s) in rows.items()},
                       gaps=dict(gaps))
