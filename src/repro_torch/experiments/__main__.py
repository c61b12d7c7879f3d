"""The paper-evaluation runner (the counterpart of the JAX package's
``experiments/run_paper_eval.py``): sweep the Matrix Market fixtures,
the paper's SuiteSparse instances (with ``--download``) and the synthetic
suite through the local backends, "auto" and the process grids via the
``solve()``/``Matcher`` facade; certify every result with LP-dual
potentials; fail on an unsound bound, a backend that disagrees with
"reference", or an imperfect matching.

    python -m repro_torch.experiments [--device cpu] [--quick]
        [--backends reference,torch,cuda,cuda_persistent,auto]
        [--grids 1x1,2x2] [--suite-count 10] [--suite-n 96]
        [--transform log2_scaled_nonneg] [--oracle-max-n 256]
        [--no-persist] [--out-dir DIR]
        [--download [--instances Freescale1,rajat31] [--cache-dir DIR]]

Without ``--device`` it runs on the card and fails without one; on the
card it runs the 1x1 grid (one NCCL rank), on the CPU the 1x1 grid in
this process and larger grids as spawned gloo ranks. ``--quick``:
fixtures and 3 small synthetic matrices, "reference" and "torch", the 1x1
grid. Outputs: ``results/torch/paper_eval.md`` and ``.json``.

``--download`` puts the named instances (default: the whole registry of
``data.suitesparse.PAPER_INSTANCES``; ``--instances`` takes registry
names or ``Group/name`` specs) into the cache (``--cache-dir``, else
``$REPRO_SUITESPARSE_CACHE`` or ``~/.cache/repro-suitesparse``) and
sweeps them beside the fixtures, in the paper's metric. An instance
whose ``<cache>/<Group>/<name>/<name>.mtx`` is already there, or whose
``<cache>/<Group>/<name>.tar.gz`` is, needs no network: to run the
paper's instances offline, put their files there first. Without
``--download`` nothing touches the network.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments import paper_eval


def _parse_grids(text: str):
    grids = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            continue
        try:
            pr, pc = (int(t) for t in tok.split("x"))
        except ValueError:
            raise SystemExit(f"bad grid {tok!r}: expected PRxPC, e.g. 2x2")
        grids.append((pr, pc))
    return grids


def main(argv=None) -> list:
    """Run the sweep of ``argv``'s flags; print its table and return its
    records."""
    ap = argparse.ArgumentParser(
        description="AWPM quality evaluation in the paper's metric")
    ap.add_argument("--device", default=None,
                    help="'cpu' on the host; default: the card")
    ap.add_argument("--quick", action="store_true",
                    help="fixtures + 3 small synthetic matrices, "
                         "reference/torch, the 1x1 grid")
    ap.add_argument("--backends", default=None,
                    help="comma list from reference,torch,cuda,"
                         "cuda_persistent,auto (default: all five; "
                         "--quick: reference,torch)")
    ap.add_argument("--grids", default=None,
                    help="comma list of PRxPC grids (default: 1x1,2x2 on "
                         "the CPU, 1x1 on the card; --quick: 1x1)")
    ap.add_argument("--suite-count", type=int, default=None,
                    help="number of synthetic suite matrices (default 10)")
    ap.add_argument("--suite-n", type=int, default=None,
                    help="synthetic matrix size (default 96)")
    ap.add_argument("--transform", default=None,
                    help="re-measure the synthetic suite in this weight "
                         "metric (e.g. log2_scaled_nonneg)")
    ap.add_argument("--oracle-max-n", type=int, default=256,
                    help="run the exact scipy oracle up to this n")
    ap.add_argument("--no-persist", action="store_true",
                    help="write no output files")
    ap.add_argument("--out-dir", default=None,
                    help="where the outputs go (default results/torch/)")
    ap.add_argument("--download", action="store_true",
                    help="opt-in network: fetch SuiteSparse instances "
                         "(sha256-pinned cache) and sweep them too; a "
                         "filled cache needs no network")
    ap.add_argument("--instances", default=None,
                    help="with --download: comma list of registry names or "
                         "Group/name specs (default: the paper registry)")
    ap.add_argument("--cache-dir", default=None,
                    help="SuiteSparse cache dir (default: "
                         "$REPRO_SUITESPARSE_CACHE or "
                         "~/.cache/repro-suitesparse)")
    args = ap.parse_args(argv)

    spec = dict(paper_eval.QUICK_SPEC if args.quick
                else paper_eval.DEFAULT_SPEC)
    if args.suite_count is not None:
        spec["synthetic_count"] = args.suite_count
    if args.suite_n is not None:
        spec["synthetic_n"] = args.suite_n
    if args.transform is not None:
        spec["synthetic_transform"] = args.transform
    if args.instances and not args.download:
        raise SystemExit("--instances needs --download (no implicit network)")
    if args.download:
        from repro_torch.data import suitesparse

        names = ([t.strip() for t in args.instances.split(",") if t.strip()]
                 if args.instances else None)
        fetched = suitesparse.fetch_paper_instances(names,
                                                    cache=args.cache_dir)
        spec["extra_mtx"] = sorted(str(p) for p in fetched.values())
        print(f"# suitesparse: {len(fetched)} instance(s) cached under "
              f"{suitesparse.cache_dir(args.cache_dir)}")
    backends = (args.backends.split(",") if args.backends
                else (["reference", "torch"] if args.quick
                      else list(paper_eval.DEFAULT_BACKENDS)))
    grids = _parse_grids(args.grids) if args.grids \
        else ([(1, 1)] if args.quick else None)

    from repro_torch.core.single import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    records = paper_eval.run_eval(spec, backends=backends, grids=grids,
                                  oracle_max_n=args.oracle_max_n,
                                  device=device)
    wall = time.perf_counter() - t0
    print(paper_eval.to_markdown(records))
    n_tight = sum(r.tight for r in records)
    bounds = [r.ratio_bound for r in records if r.ratio_bound is not None]
    print(f"# {len(records)} rows on {device} in {wall:.1f}s: {n_tight} "
          f"certified optimal, min certified ratio bound "
          f"{min(bounds):.4f}" if bounds else "# no ratio bounds", flush=True)
    if not args.no_persist:
        table, bench = paper_eval.write_outputs(
            records, wall, out_dir=args.out_dir, quick=args.quick,
            device=device)
        print(f"# wrote {table} and {bench} ({len(records)} rows)")
    return records


if __name__ == "__main__":
    main()
