#!/usr/bin/env python3
"""What the program's tracer (``repro_torch.obs``) costs and what it sees,
for one cell of the benchmark (``BENCHMARK.json``, ``bench/``), on the card.

``cost``: the cell's pattern and traffic, its set-up calls, then blocks of
``--calls`` calls with the tracer off, on, on, off, ..., no profiler,
each call timed on the host clock ending in a sync (as the benchmark's
caller does). Prints the median ms a call off and on, the on-cost, and
from the on blocks' record: spans, counter totals and reads per call,
the copy / scan split of preflight, the time inside ``d2h.*`` spans and
the ``solve`` root's self time.

``trace``: one ``--trace 1`` run of the cell through the benchmark's
harness, as ``bench/run.py`` makes it. Prints its result line, the whole
idle-gap table (the result keeps the ten largest), the share of the idle
time inside the benchmark's ``solve`` span that is charged to a program
span, and the root's self time from the program's record.

``syncs``: the cell's set-up calls, then ``--calls`` calls with the
tracer on and ``torch.cuda.set_sync_debug_mode("warn")``: every operation
that synchronizes the host with the card, per call, by the read span
(``d2h.<site>``) open at it, or else by the innermost span (outside any
read: an implicit sync, such as a masked select's or ``bincount``'s
size, which ``d2h.reads`` does not count), and each implicit sync's line
of source; beside ``d2h.reads`` per call.

``micro`` (any device): nanoseconds of one span, step, read span, flag
and counter site, the tracer off and on (no profiler), against a bare
``bool``.

``--device cpu --size N,NNZ`` rehearses ``cost`` and ``trace`` on the CPU
at a small size.

    python3 tools/solve_trace.py cost --workload powerlaw_2m7.cold \\
        --seed 7 --calls 6 --rounds 2
    python3 tools/solve_trace.py trace --workload powerlaw_2m7.cold \\
        --seed 7 --seconds 51
    python3 tools/solve_trace.py syncs --workload powerlaw_2m7.cold \\
        --seed 7 --calls 2
    python3 tools/solve_trace.py micro
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import statistics
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402

#: spans that are the benchmark's own (``bench/tracing.py``), inside its
#: ``solve`` span; ``values`` and the gaps between calls lie outside it
BENCH_SPANS = ("solve", "preflight", "greedy", "mcm", "warm_state", "awac")
PROGRAM = "repro_torch."


def self_share(trace) -> float | None:
    """The ``solve`` roots' time not covered by their direct children, as a
    share of the roots' time."""
    roots = trace.calls()
    if not roots:
        return None
    ids = {r.id for r in roots}
    kids = collections.defaultdict(list)
    for s in trace.spans:
        if s.parent in ids:
            kids[s.parent].append((s.start_ns, s.end_ns))
    total = covered = 0
    for r in roots:
        total += r.ns
        end = r.start_ns
        for s, e in sorted(kids[r.id]):
            s = max(s, end)
            if e > s:
                covered += e - s
                end = e
    return 1 - covered / total


def summary(trace, calls: int) -> dict:
    """Per-call totals of the record of ``calls`` calls."""
    ms = collections.defaultdict(float)
    for s in trace.spans:
        ms[s.name] += s.ns / 1e6 / calls
    counters = collections.Counter()
    for per in trace.counts.values():
        counters.update(per)
    layers = trace.named("mcm.layer")
    return {
        "calls": calls,
        "spans_per_call": len(trace.spans) / calls,
        "counters_per_call": {k: v / calls for k, v in counters.items()},
        "ms_per_call": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
        "sync_wait_ms": sum(v for k, v in ms.items()
                            if k.startswith("d2h.")),
        "mcm_layer_ms": (sum(s.ns for s in layers) / 1e6 / len(layers)
                         if layers else None),
        "root_self_share": self_share(trace),
    }


def card(device) -> str:
    import subprocess
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=20)
    return out.stdout.strip()


def config_of(args):
    """The cell's configuration, resized by ``--size``."""
    from bench import harness

    _, config, _ = harness.resolve(harness.load_spec(), args.workload)
    if args.size:
        n, nnz = (int(x) for x in args.size.split(","))
        config = dict(config, n=n, nnz=nnz)
    return config


def caller_of(args):
    """(the caller of the cell's calls, done with its set-up calls, the
    device)."""
    from bench import harness
    from bench.gen.pattern import make_pattern
    from bench.gen.traffic import Stream
    from repro_torch.core import api
    from repro_torch.kernels import backend

    device = torch.device(args.device)
    config = config_of(args)
    _, _, mix = harness.resolve(harness.load_spec(), args.workload, config)
    if device.type == "cuda":
        backend.library()
    pattern = make_pattern(config["n"], config["nnz"], config["pattern"],
                           args.seed, device)
    stream = Stream(mix, pattern, args.seed)
    caller = harness.Caller(api, pattern, stream, device)
    for _ in range(mix.warmup_calls):
        caller.call()
    obs.take()
    return caller, device


def cost(args) -> dict:
    caller, device = caller_of(args)
    times = {"off": [], "on": []}
    traces = []
    order = ["off", "on", "on", "off"] * args.rounds
    for mode in order:
        if mode == "on":
            obs.enable()
        for _ in range(args.calls):
            t = time.perf_counter()
            caller.call()
            times[mode].append(1e3 * (time.perf_counter() - t))
        obs.disable()
        if mode == "on":
            traces.append(obs.take())
    spans = [s for t in traces for s in t.spans]
    counts = {k: v for t in traces for k, v in t.counts.items()}
    off, on = (statistics.median(times[m]) for m in ("off", "on"))
    return {
        "workload": args.workload, "seed": args.seed, "card": card(device),
        "off_ms": off, "on_ms": on, "on_cost": on / off - 1,
        "off_all": times["off"], "on_all": times["on"],
        **summary(obs.Trace(spans, counts), len(times["on"])),
    }


def trace_run(args) -> dict:
    from bench import harness, program, tracing

    keep = {}
    real = tracing.read

    def read(prof, window="window"):
        keep["trace"] = real(prof, window)
        return keep["trace"]

    tracing.read = read
    device = torch.device(args.device)
    if device.type != "cuda":  # the program's record is armed on a card
        program.wanted = lambda: True
    spec = harness.load_spec()
    t0 = time.perf_counter()
    result, _ = harness.run_cell(spec, args.workload, args.seed,
                                 args.seconds, True, device, t0,
                                 config=config_of(args))
    gaps = keep["trace"].gaps
    prog = sum(v for k, v in gaps.items() if k.startswith(PROGRAM))
    bench = sum(v for k, v in gaps.items() if k in BENCH_SPANS)
    split = program._taken[1] if program._taken else None
    return {
        "workload": args.workload, "seed": args.seed, "card": card(device),
        "wall_s": time.perf_counter() - t0, "result": result,
        "gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
        "idle_to_program": prog / (prog + bench) if prog + bench else None,
        "window": summary(split.window, split.calls) if split else None,
    }


def syncs(args) -> dict:
    """Synchronizing operations per call, by the span open at each."""
    if args.device != "cuda":
        raise SystemExit("solve_trace: syncs needs a CUDA device")
    caller, device = caller_of(args)
    seen, sites = collections.Counter(), collections.Counter()
    real = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return real(message, category, filename, lineno, file, line)
        stack = obs._stack()
        read = next((s.name for s in reversed(stack)
                     if s.name.startswith("d2h.")), None)
        seen[read or "outside a read: " + (
            stack[-1].name if stack else "outside solve")] += 1
        if read is None and stack:
            try:
                where = pathlib.Path(filename).resolve().relative_to(ROOT)
            except ValueError:
                where = pathlib.Path(filename).name
            sites[f"{where}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        obs.enable()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(args.calls):
                caller.call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            obs.disable()
    trace = obs.take()
    calls = args.calls
    inside = sum(v for k, v in seen.items() if k.startswith("d2h."))
    implicit = sum(v for k, v in seen.items()
                   if k.startswith("outside a read") and
                   not k.endswith("outside solve"))
    return {
        "workload": args.workload, "seed": args.seed, "card": card(device),
        "d2h_reads_per_call": (trace.count("d2h.reads") or 0) / calls,
        "syncs_in_reads_per_call": inside / calls,
        "implicit_syncs_in_solve_per_call": implicit / calls,
        "syncs_per_call": {k: v / calls for k, v in seen.most_common()},
        "implicit_sites_per_call": {k: v / calls
                                    for k, v in sites.most_common()},
    }


def micro(args) -> dict:
    """ns per site, the tracer off and on (no profiler), less the bare
    loop's."""
    x, n = True, args.n

    def timed(body) -> float:
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / n

    def spans():
        for _ in range(n):
            with obs.span("mcm.layer"):
                pass

    def steps():
        for _ in range(n):
            with obs.step("mcm.layer"):
                pass

    def reads():
        for _ in range(n):
            with obs.d2h("mcm_layer"):
                pass

    def flags():
        for _ in range(n):
            obs.flag(x, "greedy")

    def counts():
        for _ in range(n):
            obs.count("mcm.layers")

    def bools():
        for _ in range(n):
            bool(x)

    def loop():
        for _ in range(n):
            pass

    out = {}
    for mode in ("off", "on"):
        obs.enable() if mode == "on" else obs.disable()
        base = timed(loop)
        out[mode] = {name: timed(f) - base for name, f in (
            ("span", spans), ("step", steps), ("d2h", reads), ("flag", flags),
            ("count", counts), ("bare bool", bools))}
        obs.disable()
        obs.take()
    return {"ns_per_site": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("cost", "trace", "syncs", "micro"))
    ap.add_argument("--workload", default="powerlaw_2m7.cold")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="N,NNZ in place of the "
                    "configuration's")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if args.mode != "micro" and args.device == "cuda" and \
            not torch.cuda.is_available():
        print("solve_trace: no CUDA device is available", file=sys.stderr)
        return 2
    out = {"cost": cost, "trace": trace_run, "syncs": syncs,
           "micro": micro}[args.mode](args)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
