#!/usr/bin/env python3
"""Measure the dispatch table that ``backend="auto"`` consults
(``repro_torch.kernels.dispatch``) and write it.

For each shape class it builds one workload, takes it to its MCM state
(greedy, then MCM: not timed) and times the AWAC loop from there with
every backend of ``MEASURED_BACKENDS``:

  - ``single_small``:  one instance,  n = 128,    degree 8;
  - ``single_large``:  one instance,  n = 2^20,   degree 16;
  - ``batched_small``: B = 16,        n = 128,    degree 8;
  - ``batched_large``: B = 16,        n = 2^16,   degree 8;

(kind "uniform" for the single instances, the batch's kinds cycling
through ``graph.SUITE_KINDS``, seeds from 0). A backend's first call is
timed and recorded apart (``first_ms``); its number is the median of
``--reps`` later calls, each ending in a device sync, over the AWAC
rounds (``us_per_iter``, the JAX package's unit; every backend runs the
same rounds). A cell stops repeating once its calls have taken
``--limit-s`` seconds: it then holds fewer calls than ``--reps`` and says
so (``cut``). Every backend's final state and rounds must equal the
others', bit for bit. The winner is the fastest backend.

    python3 tools/dispatch_table.py                 # the card's entries
    python3 tools/dispatch_table.py --device cpu    # its host's CPU

Each run replaces the entries of its platform ("cuda" or "cpu") in the
table and keeps the others; ``--out`` writes elsewhere (the committed
table is ``src/repro_torch/kernels/dispatch_table.json``).
``--single-large-n`` and ``--batched-large-n`` shrink the large classes
for a rehearsal. Without a card, the default device fails.
"""
from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import MatchingProblem, batch, graph, single  # noqa: E402
from repro_torch.experiments.paper_eval import card, host_cpu  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.sparse.csr import batched_row_ptr_from_sorted  # noqa: E402


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _workload(klass: str, sizes: dict, device):
    """(the AWAC call for a backend, a description) of one class, from
    its MCM state."""
    n, b, deg = sizes[klass]
    if b is None:
        g = graph.generate(n, avg_degree=deg, kind="uniform", seed=0)
        p = MatchingProblem.from_graph(g, device=device)
        row, col, val = p.row, p.col, p.val
        st = single.greedy_maximal(row, col, val, n)
        st = single.mcm(row, col, val, n, st.mate_row, st.mate_col)

        def call(backend):
            return single.awac(row, col, val, n, st, backend=backend)

        return call, f"n={n} nnz={g.nnz} degree {deg:g}"
    kinds = graph.SUITE_KINDS
    gs = [graph.generate(n, avg_degree=deg, kind=kinds[i % len(kinds)],
                         seed=i) for i in range(b)]
    p = MatchingProblem.stack(gs, device=device)
    row, col, val = p.row, p.col, p.val
    ws = batch._resolve_window_steps_batched(row, n, None)
    rp = batched_row_ptr_from_sorted(row, n)
    mr, mc = batch.greedy_maximal_batched(row, col, val, n)
    mr, mc = batch.mcm_batched(row, col, val, n, mr, mc)
    st = batch._state_from_mates_windowed(row, col, val, rp, n, mr, mc, ws)

    def call(backend):
        return batch.awac_batched(row, col, val, n, st, backend=backend,
                                  row_ptr=rp, window_steps=ws)

    return call, f"B={b} n={n} nnz={sum(g.nnz for g in gs)} degree {deg:g}"


def _same(a, b) -> bool:
    (sa, ia), (sb, ib) = a, b
    return torch.equal(ia, ib) and all(torch.equal(x, y)
                                       for x, y in zip(sa, sb))


def measure_backends(call, device, reps: int, limit_s: float,
                     label: str = "", log=print) -> dict:
    """Time ``call(backend)`` (an AWAC loop from a fixed state) with every
    backend of ``MEASURED_BACKENDS``: the first call apart, then up to
    ``reps`` later calls within ``limit_s``. Every backend's result must
    equal the first's, bit for bit. Returns the cell, winner included."""
    cell = {"us_per_iter": {}, "ms": {}, "first_ms": {}, "reps": {},
            "iters": None}
    first_out = None
    for backend in dispatch.MEASURED_BACKENDS:
        out, first = _timed(lambda: call(backend), device)
        if first_out is None:
            first_out = out
        elif not _same(out, first_out):
            raise AssertionError(
                f"{label}: backend {backend!r} differs from "
                f"{dispatch.MEASURED_BACKENDS[0]!r}")
        times, spent = [], first
        while len(times) < reps and spent < limit_s:
            _, t = _timed(lambda: call(backend), device)
            times.append(t)
            spent += t
        if not times:  # the first call alone took the whole limit
            times = [first]
        iters = out[1].double().mean().item()
        med = statistics.median(times)
        cell["iters"] = iters
        cell["ms"][backend] = med * 1e3
        cell["first_ms"][backend] = first * 1e3
        cell["us_per_iter"][backend] = med / max(iters, 1.0) * 1e6
        cell["reps"][backend] = len(times)
        log(f"[{label}] {backend}: {med * 1e3:.3f} ms a later call (median "
            f"of {len(times)}), first call {first * 1e3:.3f} ms, {iters:g} "
            f"rounds")
    cut = [b for b, r in cell["reps"].items() if r < reps]
    if cut:
        cell["cut"] = {"backends": cut, "limit_s": limit_s}
    us = cell["us_per_iter"]
    cell["winner"] = min(us, key=us.get)
    return cell


def measure_class(klass: str, sizes: dict, device, reps: int,
                  limit_s: float, log=print) -> dict:
    call, what = _workload(klass, sizes, device)
    label = f"{device.type}/{klass}"
    cell = {"workload": what,
            **measure_backends(call, device, reps, limit_s, label, log)}
    us = cell["us_per_iter"]
    ranked = sorted(us, key=us.get)
    log(f"[{label}] {what}: winner {cell['winner']}, runner-up "
        f"{ranked[1]} at {us[ranked[1]] / us[ranked[0]]:.2f}x")
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host's entries; default: the card")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="the table to update (default: the committed one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--limit-s", type=float, default=60.0,
                    help="stop repeating a cell's calls after this long")
    ap.add_argument("--single-large-n", type=int, default=1 << 20)
    ap.add_argument("--batched-large-n", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    device = single.resolve_device(args.device)
    plat = device.type
    sizes = {"single_small": (128, None, 8.0),
             "single_large": (args.single_large_n, None, 16.0),
             "batched_small": (128, 16, 8.0),
             "batched_large": (args.batched_large_n, 16, 8.0)}
    path = args.out or dispatch.DEFAULT_TABLE_PATH
    table = dispatch.load_table(path) or {"entries": {}, "metadata": {}}
    entries = {k: v for k, v in table["entries"].items()
               if not k.startswith(f"{plat}/")}
    t0 = time.perf_counter()
    for klass in sizes:
        entries[f"{plat}/{klass}"] = measure_class(
            klass, sizes, device, args.reps, args.limit_s)
    meta = dict(table.get("metadata") or {})
    meta.update(card=card(), host_cpu=f"{host_cpu()}, "
                f"{torch.get_num_threads()} torch threads",
                torch=torch.__version__, cuda=torch.version.cuda)
    runs = dict(meta.get("runs") or {})
    runs[plat] = {
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "device": (torch.cuda.get_device_name(device) if plat == "cuda"
                   else "cpu"),
        "sizes": {k: list(v) for k, v in sizes.items()},
        "reps": args.reps, "limit_s": args.limit_s,
        "seconds": time.perf_counter() - t0,
        "measured_backends": list(dispatch.MEASURED_BACKENDS)}
    meta["runs"] = runs
    out = dispatch.save_table(dict(sorted(entries.items())), meta, path)
    print(f"[dispatch_table] {plat}: wrote {out} in "
          f"{runs[plat]['seconds']:.1f} s; card {meta['card']}")
    print(json.dumps({k: v["winner"] for k, v in sorted(entries.items())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
