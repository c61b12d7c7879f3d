#!/usr/bin/env python3
"""``chip_smoke.device_rows`` against ``key_averages()`` on the card.

Traces a mixed workload (matmuls under a ``record_function`` range, a
memset, copies to the host and back) and ``solve()`` of an n = 65,536
instance with backend "auto" and "cuda", reads each trace's device rows
both ways, and prints each row's launches and microseconds from both
and the host seconds each reading took. Fails if any row differs. With
``--loop N`` it also times both readings over a trace of N small
launches.

Run from the root of a checkout on a machine with the card:

    python3 tools/profile_rows.py [--loop 100000]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


def mixed() -> float:
    x = torch.randn(512, 512, device="cuda")
    with torch.profiler.record_function("mixed-range"):
        for _ in range(50):
            x = torch.tanh(x @ x)
    y = torch.zeros(1 << 20, device="cuda")
    return float(y.cpu().cuda().sum() + x.sum())


def compare(fn, label: str) -> bool:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = {r.key: (r.count, r.us) for r in cs.device_rows(prof)}
    t1 = time.perf_counter()
    ka = {e.key: (e.count, e.self_device_time_total)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA}
    t2 = time.perf_counter()
    ok = raw.keys() == ka.keys()
    for k in sorted(raw.keys() | ka.keys()):
        a, b = raw.get(k), ka.get(k)
        same = (a is not None and b is not None and a[0] == b[0]
                and abs(a[1] - b[1]) <= 1e-6 * b[1] + 0.01)
        ok &= same
        if not same:
            print(f"[rows] {label}: DIFFERS {k[:90]}: {a} / {b}")
    print(f"[rows] {label}: {len(raw)} rows, "
          f"{sum(c for c, _ in raw.values())} launches, "
          f"{'all equal' if ok else 'NOT equal'}; device_rows {t1 - t0:.3f} "
          f"s, key_averages {t2 - t1:.3f} s")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loop", type=int, default=0,
                    help="also time both readings over N small launches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rows: no CUDA device is available", file=sys.stderr)
        return 2
    cs.backend.library()
    p = cs.MatchingProblem.from_graph(cs.graph.generate(
        65_536, avg_degree=8.0, kind="antigreedy", seed=0))
    ok = compare(mixed, "mixed")
    ok &= compare(lambda: cs.solve(p), "solve() auto")
    ok &= compare(lambda: cs.solve(p, cs.SolveOptions(backend="cuda")),
                  "solve() cuda")
    if args.loop:
        x = torch.zeros(1024, device="cuda")
        ok &= compare(lambda: [x.add_(1.0) for _ in range(args.loop)],
                      f"{args.loop} launches")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
