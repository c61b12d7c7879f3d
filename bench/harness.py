"""One run of one cell of the benchmark: set-up, the measured window, the
check against the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file, the traffic mix ``bench/traffic/<traffic>.json``,
and a reader ``bench/metrics/<metric>.py`` for every metric the run
reports. The system under test is ``repro_torch.core.api.solve``, called
with ``SolveOptions()`` defaults by one caller in a closed loop: with one
[cap] problem a call, or, where the configuration has ``batch``, one
[B, cap] problem of its lanes (``bench/gen/pattern.py::make_lanes``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import random
import sys
import time
import traceback

import torch

from bench import tracing
from bench.gen.pattern import Pattern, make_lanes
from bench.gen.seeds import derive
from bench.gen.traffic import Mix, Stream
from bench.reference.awpm import Reference, preflight_issues
from bench.reference.check import Served, Tally

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
#: calls that the reference solves again, cold or warm mix: the window's
#: first and last, and the rest drawn from the seed (``Held``)
CHECK_COLD_CALLS = 8
#: the most calls a window makes, by whether the run is traced (None: no
#: cap): the profiler records every operation of every call it sees
MOST_CALLS = {False: None, True: 128}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_spec(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics (all
    but those listing other cells only), or with the trace the per-layer
    metrics that list it."""
    if traced:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", (cell,))]


def load_reader(name: str):
    """``bench/metrics/<name>.py``, loaded by its path (a metric's name
    may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Record:
    """What the metric readers read from one run."""

    n: int
    nnz: int  # a lane's
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    rounds: list[int]  # AWAC rounds of each lane of each completed call
    spans: dict[str, list[float]]  # traced run: host seconds of each span
    trace: tracing.DeviceTrace | None  # traced run on the card

    @property
    def completed(self) -> int:
        return self.attempted - self.failed

    def span_ms(self, name: str) -> float | None:
        """Milliseconds of span ``name`` per completed call; None where
        the span never opened."""
        xs = self.spans.get(name)
        if not xs or not self.completed:
            return None
        return 1e3 * sum(xs) / self.completed


def served_lanes(res, lanes: int) -> list[Served]:
    """``solve()``'s result as the caller holds it, lane by lane: three
    reads of the device, whatever the lanes."""
    rounds = res.awac_iters.reshape(-1).tolist()
    perfect = res.perfect.reshape(-1).tolist()
    weight = res.weight.reshape(-1).tolist()
    mr = res.mate_row.reshape(lanes, -1)
    mc = res.mate_col.reshape(lanes, -1)
    issues = [set() for _ in range(lanes)]
    for i in res.diagnosis.issues if res.diagnosis is not None else ():
        issues[i.instance or 0].add(i.kind)
    return [Served(mate_row=mr[b], mate_col=mc[b], rounds=rounds[b],
                   perfect=perfect[b], weight=weight[b],
                   issues=frozenset(issues[b])) for b in range(lanes)]


class Caller:
    """The closed-loop caller: each call makes its values, builds the
    problem ([cap], or [B, cap] of a batched configuration's lanes), solves
    it (warm-started where the mix says) and holds the result once the
    device is done."""

    def __init__(self, api, lanes: list[Pattern], batched: bool,
                 stream: Stream, device):
        self.api, self.lanes, self.stream = api, lanes, stream
        self.batched = batched
        if batched:
            self.row = torch.stack([p.row for p in lanes])
            self.col = torch.stack([p.col for p in lanes])
        else:
            self.row, self.col = lanes[0].row, lanes[0].col
        self.sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda: None)
        self.prev = None
        self.spans: tracing.Spans | None = None

    def _span(self, name: str):
        return self.spans.span(name) if self.spans else \
            contextlib.nullcontext()

    def call(self) -> list[Served]:
        warm = self.stream.warm(self.stream.call)
        with self._span("values"):
            vals = self.stream.next()
            val = torch.stack(vals) if self.batched else vals[0]
            problem = self.api.MatchingProblem(row=self.row, col=self.col,
                                               val=val, n=self.lanes[0].n)
        with self._span("solve"):
            if warm:
                res = self.api.solve(problem, warm_start=self.prev)
            else:
                res = self.api.solve(problem)
            self.sync()
        if self.stream.mix.warm_start:  # the next call's seed
            self.prev = res
        return served_lanes(res, len(self.lanes))


class Held:
    """The answers of a window that the check needs, picked and kept while
    the window runs; every other answer is dropped at once, so that what
    stays on the card does not grow with the window's calls.

    The checked calls (``targets``) are the window's first and last call
    and, between them, as many calls as make ``CHECK_COLD_CALLS`` in all,
    drawn by a reservoir (Algorithm R) from a generator seeded from the
    run's seed: the same seed and window pick the same calls. A warm call
    is checked one step from the answer that seeded it, the program's
    previous one, so a warm mix keeps that answer beside each checked call,
    and the last answer as the next call's seed; the first window call's
    seed is the last warm-up answer. A warm mix's chain starts at the
    set-up's first call, which is cold: that call is checked too, in place
    of one drawn call. At most ``2 * CHECK_COLD_CALLS`` answers are kept
    at any time (``most``), ``CHECK_COLD_CALLS`` for a cold mix."""

    def __init__(self, seed: int, warm: bool):
        self.rng = random.Random(derive(seed, "check"))
        self.warm = warm
        self.answers: dict[int, list[Served]] = {}
        self.seed_of: dict[int, int | None] = {}  # call -> call that seeded it
        self.start: int | None = None  # a warm chain's cold start
        self.first: int | None = None
        self.last: int | None = None
        self.inner: list[int] = []  # the reservoir
        self.size = CHECK_COLD_CALLS - 2 - int(warm)
        self.offered = 0  # inner calls offered to it
        self.prev: int | None = None  # the last call that was answered
        self.most = 0

    @property
    def targets(self) -> list[int]:
        return sorted({self.start, self.first, self.last, *self.inner}
                      - {None})

    def warmed(self, call: int, answer: list[Served]) -> None:
        """A set-up call's answer: the first is a warm chain's start, the
        last the first window call's seed."""
        if self.warm and self.start is None:
            self.start = call
        self.answers[call] = answer
        self.prev = call
        self._drop()

    def add(self, call: int, answer: list[Served] | None, last: bool) -> None:
        """Window call ``call``'s answer (None: it raised); ``last``: the
        window ends with it."""
        if answer is not None:
            self.answers[call] = answer
        self.seed_of[call] = self.prev
        if self.first is None:
            self.first = call
        elif last:
            self.last = call
        else:
            self.offered += 1
            if len(self.inner) < self.size:
                self.inner.append(call)
            else:
                j = self.rng.randrange(self.offered)
                if j < len(self.inner):
                    self.inner[j] = call
        if answer is not None:
            self.prev = call
        self._drop()

    def _drop(self) -> None:
        targets = self.targets
        self.seed_of = {k: self.seed_of[k] for k in targets
                        if k in self.seed_of}
        keep = set(targets)
        if self.warm:
            keep |= set(self.seed_of.values())
            if self.last is None:
                keep.add(self.prev)
        for k in list(self.answers):
            if k not in keep:
                del self.answers[k]
        self.most = max(self.most, len(self.answers))

    def nbytes(self) -> int:
        """Bytes on the device under the kept answers' mates."""
        seen = {}
        for answer in self.answers.values():
            for s in answer:
                for t in (s.mate_row, s.mate_col):
                    st = t.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())


def check(lanes: list[Pattern], mix: Mix, held: Held) -> Tally:
    """Solve the checked calls (``held.targets``) again with the reference,
    one a lane, on values made again from the seeds (a warm call from the
    program's answer that seeded it), and hold every lane of each answer
    the program gave against it."""
    targets = set(held.targets)
    refs = [Reference(p.row, p.col, p.n) for p in lanes]
    stream = Stream(mix, lanes)
    tally = Tally()
    for k in range(max(targets, default=-1) + 1):
        if k not in targets:
            stream.skip()
            continue
        warm = stream.warm(k)
        vals = stream.next()
        got = held.answers.get(k)
        seed = held.answers[held.seed_of[k]] if warm else None
        for b, (ref, val, p) in enumerate(zip(refs, vals, lanes)):
            ans = ref.warm(val, seed[b].mate_row, seed[b].mate_col) if warm \
                else ref.cold(val)
            tally.add(k, got[b] if got is not None else None, ans,
                      preflight_issues(p.row, p.col, val, p.n), b)
    return tally


def device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": peak}


def resolve(spec: dict, name: str, config: dict | None = None):
    """Cell ``name``'s entry, its configuration (``config`` stands in for
    the file) and its traffic mix."""
    cell = workload(spec, name)
    if config is None:
        entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
        with open(ROOT / entry["file"]) as f:
            config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        mix = Mix.from_json(json.load(f))
    return cell, config, mix


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             config: dict | None = None) -> tuple[dict, Tally]:
    """One run of cell ``name``; returns the result line's object and the
    tally of the check. ``t_start`` is the process's start on the host
    clock (set-up counts from it). ``config`` stands in for the cell's
    configuration file (the tests' small sizes)."""
    cell, config, mix = resolve(spec, name, config)
    metrics = metrics_of(spec, name, traced)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}

    marks = [("start", time.perf_counter() - t_start)]
    from repro_torch.core import api  # the system under test

    if device.type == "cuda":
        from repro_torch.kernels import backend
        backend.library()
        torch.cuda.synchronize()
    marks.append(("port", time.perf_counter() - t_start))
    lanes = make_lanes(config, seed, device)
    stream = Stream(mix, lanes)
    caller = Caller(api, lanes, "batch" in config, stream, device)
    marks.append(("pattern", time.perf_counter() - t_start))
    held = Held(seed, mix.warm_start)
    for k in range(mix.warmup_calls):
        held.warmed(k, caller.call())
        marks.append((f"call {k}", time.perf_counter() - t_start))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {len(lanes)} lane(s) of n {lanes[0].n}, "
        f"nnz {lanes[0].nnz}, {mix.warmup_calls} warm-up call(s); done at (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in marks))

    spans = tracing.Spans(device)
    most = MOST_CALLS[traced]
    rounds: list[int] = []
    attempted = failed = 0
    with contextlib.ExitStack() as stack:
        prof = None
        if traced:
            for reader in readers.values():
                for module, attr in getattr(reader, "WRAPS", ()):
                    spans.wrap(reader.SPAN, module, attr)
            caller.spans = spans
            stack.callback(spans.restore)
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]))
            stack.enter_context(torch.profiler.record_function(
                tracing.PREFIX + "window"))
        t0 = t = time.perf_counter()
        call_ms = []
        while True:
            k = stream.call
            attempted += 1
            got = None
            try:
                got = caller.call()
            except Exception:  # a call that raises is a failed request
                failed += 1
                log(f"call {k} failed:\n{traceback.format_exc()}")
            call_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            last = t - t0 >= seconds or attempted == most
            held.add(k, got, last)
            rounds += [s.rounds for s in got or ()]
            if last:
                break
        window_s = t - t0
    caller.spans = None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    dtrace = tracing.read(prof) if prof is not None else None
    cap = f"cap {most}" if most else "no cap"
    log(f"window {window_s:.3f} s: {attempted} calls ({cap}), {failed} "
        f"failed; ms a call: {' '.join(f'{x:.0f}' for x in call_ms)}"
        + (f"; trace closed and read in {time.perf_counter() - t:.3f} s"
           if traced else ""))
    log(f"held for the check: at most {held.most} answer(s) at once, at the "
        f"close {len(held.answers)} ({held.nbytes()} B of mates); peak "
        f"{peak} B")

    caller.prev = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    tally = check(lanes, mix, held)
    log(f"check {time.perf_counter() - t_check:.3f} s: {tally.checked} "
        f"call(s), {tally.lanes} lane(s) against the reference"
        + (f", first off at call {tally.first_off}"
           if tally.first_off is not None else ""))

    record = Record(n=lanes[0].n, nnz=lanes[0].nnz, setup_s=setup_s,
                    window_s=window_s, attempted=attempted, failed=failed,
                    rounds=rounds, spans=dict(spans.seconds), trace=dtrace)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(record)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": failed == 0 and attempted > 0 and tally.passed(),
        "attempted": attempted,
        "failed": failed,
        "metrics": values,
        "device": device_info(device, cell["chips"], peak),
    }
    if dtrace is not None:
        result["device"].update(busy_s=dtrace.busy_s,
                                window_s=dtrace.window_s)
        result["breakdown"] = dtrace.breakdown()
    result["checks"] = tally.report()
    return result, tally
