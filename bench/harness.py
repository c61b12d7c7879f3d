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
#: calls of a cold mix that the reference solves again: the window's first
#: and last, and the rest drawn from the seed (a warm mix's chain is
#: followed through every call)
CHECK_COLD_CALLS = 8


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
        self.prev = res
        return served_lanes(res, len(self.lanes))


def answers(refs: list[Reference], lanes: list[Pattern], mix: Mix,
            targets: set[int], stop: int):
    """(call, lane, values, answer) of ``refs`` (one a lane) for each lane
    of each call in ``targets`` below ``stop``, the values made again from
    the seeds; a warm mix's chain is followed from call 0, lane by lane, on
    the references' own answers."""
    stream, prev = Stream(mix, lanes), [None] * len(lanes)
    for k in range(stop):
        warm = stream.warm(k)
        vals = stream.next()
        if k not in targets and not mix.warm_start:
            continue
        for b, (ref, val) in enumerate(zip(refs, vals)):
            ans = ref.warm(val, prev[b].mate_row, prev[b].mate_col) if warm \
                else ref.cold(val)
            if k in targets:
                yield k, b, val, ans
            prev[b] = ans


def check_targets(mix: Mix, seed: int, window: range) -> set[int]:
    """The calls of ``window`` that the check solves again, every lane of
    each: every call of a warm mix; of a cold mix the first, the last and
    the rest of ``CHECK_COLD_CALLS`` drawn from the seed."""
    if mix.warm_start or len(window) <= CHECK_COLD_CALLS:
        return set(window)
    g = torch.Generator().manual_seed(derive(seed, "check"))
    inner = window[1:-1]
    pick = torch.randperm(len(inner), generator=g)[:CHECK_COLD_CALLS - 2]
    return {window[0], window[-1]} | {inner[int(i)] for i in pick}


def check(lanes: list[Pattern], mix: Mix, seed: int,
          served: dict[int, list[Served]], window: range) -> Tally:
    """Solve the checked calls (``check_targets``) again with the
    reference, one a lane, from the seeds, and hold every lane of each
    answer the program gave against it."""
    targets = check_targets(mix, seed, window)
    refs = [Reference(p.row, p.col, p.n) for p in lanes]
    tally = Tally()
    for k, b, val, ans in answers(refs, lanes, mix, targets, window.stop):
        p = lanes[b]
        got = served[k][b] if k in served else None
        tally.add(k, got, ans, preflight_issues(p.row, p.col, val, p.n), b)
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
    for k in range(mix.warmup_calls):
        caller.call()
        marks.append((f"call {k}", time.perf_counter() - t_start))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {len(lanes)} lane(s) of n {lanes[0].n}, "
        f"nnz {lanes[0].nnz}, {mix.warmup_calls} warm-up call(s); done at (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in marks))

    spans = tracing.Spans(device)
    served: dict[int, list[Served]] = {}
    attempted = failed = 0
    first = stream.call
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
            try:
                served[k] = caller.call()
            except Exception:  # a call that raises is a failed request
                failed += 1
                log(f"call {k} failed:\n{traceback.format_exc()}")
            call_ms.append(1e3 * (time.perf_counter() - t))
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        window_s = t - t0
    caller.spans = None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    dtrace = tracing.read(prof) if prof is not None else None
    window = range(first, stream.call)
    log(f"window {window_s:.3f} s: {attempted} calls, {failed} failed; ms "
        f"a call: {' '.join(f'{x:.0f}' for x in call_ms)}"
        + (f"; trace closed and read in {time.perf_counter() - t:.3f} s"
           if traced else ""))

    caller.prev = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    tally = check(lanes, mix, seed, served, window)
    log(f"check {time.perf_counter() - t_check:.3f} s: {tally.checked} "
        f"call(s), {tally.lanes} lane(s) against the reference"
        + (f", first off at call {tally.first_off}"
           if tally.first_off is not None else ""))

    record = Record(n=lanes[0].n, nnz=lanes[0].nnz, setup_s=setup_s,
                    window_s=window_s, attempted=attempted, failed=failed,
                    rounds=[s.rounds for k in window if k in served
                            for s in served[k]],
                    spans=dict(spans.seconds), trace=dtrace)
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
