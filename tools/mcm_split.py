#!/usr/bin/env python3
"""Where the local engines' MCM time goes on the card, for one checkout.

Imports the port of a checkout (this one, or ``--root``, such as the
parent commit unpacked beside it) and, on the instances ``chip_smoke.py``
measures (its one instance at n = 2^20, degree 16, "antigreedy", seed 0,
and its batch of 16 at n = 2^16), prints:

  - ``solve()`` with backend "auto", host clock ending in a device sync,
    after one warm-up call, three calls;
  - the greedy / MCM split of the single-instance engine, from the greedy
    state: MCM in its kernel (backend "cuda_persistent", one launch; its
    phases and BFS layers from the kernel's stats) beside the plain
    version (backend "torch"), phase by phase, with its BFS and
    trace/flip seconds, phases and BFS layers; a checkout without the
    kernel times the plain version alone;
  - one ``solve()`` under ``torch.profiler``: the device's busy share and
    the kernels that take its time, ``scatter_reduce``'s among them;
  - the batch's ``solve()``, three calls after a warm-up.

Run from the root of a checkout on a machine with the card:

    python3 tools/mcm_split.py [--root CHECKOUT] [--out FILE]
        [--n N --degree D --kind KIND --seed S]

Compare two checkouts within one call (parent, change, change, parent):
each run is its own process, so each imports its own port.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HERE = pathlib.Path(__file__).resolve().parents[1]
SINGLE = dict(n=1_048_576, avg_degree=16.0, kind="antigreedy", seed=0)
BATCH = dict(b=16, n=65_536, avg_degree=8.0)


def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def mcm_split(single, row, col, val, n, mr, mc):
    """The plain version of ``single.mcm`` from the greedy state, phase by
    phase."""
    out = dict(phases=0, layers=0, bfs_s=0.0, flip_s=0.0)
    go = True
    while go and bool((mr[:n] == n).any()):
        (pc, vis, go, layers), dt = wall(
            lambda: single._mcm_bfs(row, col, val, n, mr, mc))
        out["bfs_s"] += dt
        (mr, mc), dt = wall(lambda: single.trace_and_flip(
            pc, vis, go, layers, mr, mc, n))
        out["flip_s"] += dt
        out["phases"] += 1
        out["layers"] += layers
    out["mcm_s"] = out["bfs_s"] + out["flip_s"]
    return out, mr


def mcm_kernel(single, row, col, val, n, mr, mc):
    """``single.mcm`` in its kernel from the greedy state, three calls
    after a warm-up, and the kernel's stats; None where the checkout has
    no MCM kernel."""
    if "backend" not in inspect.signature(single.mcm).parameters:
        return None, None
    from repro_torch.kernels.mcm.persistent import mcm_persistent
    from repro_torch.sparse.csr import row_ptr_from_sorted

    def call():
        return single.mcm(row, col, val, n, mr, mc,
                          backend="cuda_persistent")

    call()
    times = [wall(call)[1] for _ in range(3)]
    st = call()
    rp = row_ptr_from_sorted(row, n)
    _, _, stats = mcm_persistent(row, col, val, rp, single._with_sentinel(
        mr, n), single._with_sentinel(mc, n), n=n)
    phases, layers, free = stats.tolist()
    return dict(mcm_s=times, phases=phases, layers=layers,
                free=bool(free)), st.mate_row


def busy(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in rows)
    scatter = [e for e in rows if "scatter" in e.key]
    top = sorted(rows, key=dev_us, reverse=True)[:6]
    return dict(wall_s=t, device_busy_s=busy_us / 1e6,
                busy_share=busy_us / 1e6 / t,
                launches=sum(e.count for e in rows),
                scatter_ms=sum(dev_us(e) for e in scatter) / 1e3,
                scatter_launches=sum(e.count for e in scatter),
                top=[(e.key[:70], dev_us(e) / 1e3, e.count) for e in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose port is measured")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the measurements to this JSON file")
    ap.add_argument("--n", type=int, default=SINGLE["n"])
    ap.add_argument("--degree", type=float, default=SINGLE["avg_degree"])
    ap.add_argument("--kind", default=SINGLE["kind"])
    ap.add_argument("--seed", type=int, default=SINGLE["seed"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mcm_split: no CUDA device is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import MatchingProblem, graph, single, solve
    from repro_torch.kernels import backend

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    backend.library()
    log = dict(root=str(root), card=card)
    g = graph.generate(args.n, avg_degree=args.degree, kind=args.kind,
                       seed=args.seed)
    p = MatchingProblem.from_graph(g)
    n = g.n
    ref, _ = wall(lambda: solve(p))
    log["solve_s"] = [wall(lambda: solve(p))[1] for _ in range(3)]
    st = single.greedy_maximal(p.row, p.col, p.val, n)
    split, mr = mcm_split(single, p.row, p.col, p.val, n, st.mate_row,
                          st.mate_col)
    log["mcm"] = split
    kern, kmr = mcm_kernel(single, p.row, p.col, p.val, n, st.mate_row,
                           st.mate_col)
    log["mcm_kernel"] = kern
    if kern is not None and not torch.equal(kmr, mr):
        print("mcm_split: the MCM kernel's mates differ from the plain "
              "version's", file=sys.stderr)
        return 1
    log["profile"] = busy(lambda: solve(p))
    del p, g
    kinds = graph.SUITE_KINDS
    pb = MatchingProblem.stack([
        graph.generate(BATCH["n"], avg_degree=BATCH["avg_degree"],
                       kind=kinds[i % len(kinds)], seed=i)
        for i in range(BATCH["b"])])
    rb, _ = wall(lambda: solve(pb))
    log["batch_solve_s"] = [wall(lambda: solve(pb))[1] for _ in range(3)]
    # a fingerprint of the results, equal across checkouts
    log["digest"] = dict(iters=int(ref.awac_iters),
                         weight=float(ref.weight),
                         mate_row_sum=int(ref.mate_row.long().sum()),
                         batch_iters=rb.awac_iters.tolist())
    prof = log["profile"]
    print(f"[mcm_split] {root.name or root}: {card}")
    print(f"[mcm_split] n={n}: solve() auto "
          f"{', '.join(f'{t:.3f}' for t in log['solve_s'])} s; MCM plain "
          f"{split['mcm_s']:.3f} s ({split['phases']} phases, "
          f"{split['layers']} BFS layers; BFS {split['bfs_s']:.3f} s, "
          f"trace/flip {split['flip_s']:.3f} s)")
    if kern is not None:
        print(f"[mcm_split] MCM kernel "
              f"{', '.join(f'{t:.4f}' for t in kern['mcm_s'])} s "
              f"({kern['phases']} phases, {kern['layers']} BFS layers, a "
              f"column free: {kern['free']}); mates equal to the plain "
              f"version's")
    print(f"[mcm_split] one solve() under the profiler: {prof['wall_s']:.3f} "
          f"s wall, device busy {prof['device_busy_s']:.3f} s "
          f"({100 * prof['busy_share']:.1f}%), {prof['launches']} launches; "
          f"scatter kernels {prof['scatter_ms']:.1f} ms over "
          f"{prof['scatter_launches']} launches; top {prof['top']}")
    print(f"[mcm_split] B={BATCH['b']} n={BATCH['n']}: solve() "
          f"{', '.join(f'{t:.3f}' for t in log['batch_solve_s'])} s; "
          f"digest {log['digest']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
