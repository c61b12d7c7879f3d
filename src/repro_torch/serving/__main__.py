"""``python -m repro_torch.serving`` — run the matching service against an
open-loop synthetic stream and print the serving report.

The knobs mirror ``ServiceConfig`` + ``loadgen.StreamSpec``, plus
``--device`` (default: the card; ``--device cpu`` runs the solves on the
CPU). Without a card and without ``--device cpu`` it fails with "no CUDA
device".
"""
from __future__ import annotations

import argparse

from repro_torch.serving.loadgen import StreamSpec, run_stream
from repro_torch.serving.service import MatchingService, ServiceConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="open-loop demo of the matching service")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--users", type=int, default=16)
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--avg-degree", type=float, default=5.0)
    ap.add_argument("--rate", type=float, default=400.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--deadline-ms", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--jitter", type=float, default=0.02,
                    help="relative weight perturbation per repeat")
    ap.add_argument("--churn", type=float, default=0.1,
                    help="P(drop one edge) per repeat")
    ap.add_argument("--kind", default="uniform")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-warm", action="store_true",
                    help="disable warm-start rematching")
    ap.add_argument("--resilient", action="store_true",
                    help="serve through runtime.resilient rung chains")
    ap.add_argument("--device", default=None,
                    help="device of the solves (default: the card)")
    args = ap.parse_args(argv)

    service = MatchingService(ServiceConfig(
        num_shards=args.shards, deadline_s=args.deadline_ms / 1e3,
        max_batch=args.batch, warm_start=not args.no_warm,
        resilient=args.resilient), device=args.device)
    spec = StreamSpec(
        requests=args.requests, users=args.users, n=args.n,
        avg_degree=args.avg_degree, rate_rps=args.rate,
        weight_jitter=args.jitter, structure_churn=args.churn,
        kind=args.kind, seed=args.seed)
    summary = run_stream(service, spec)

    print(f"# open-loop stream: {spec.requests} requests, {spec.users} "
          f"users, n={spec.n}, {spec.rate_rps:.0f} rps offered, solves on "
          f"{service.device}")
    print(f"served        {summary['served']} "
          f"({summary['served_warm']} warm / {summary['served_cold']} cold, "
          f"{summary['degraded']} degraded, {summary['rejected']} rejected)")
    print(f"throughput    {summary['throughput_rps']:.1f} requests/s")
    print(f"latency       p50 {summary['p50_us']:.0f}us   "
          f"p95 {summary['p95_us']:.0f}us   p99 {summary['p99_us']:.0f}us")
    print(f"batch fill    {summary['mean_fill']:.2f} avg "
          f"(solve {summary['mean_solve_us']:.0f}us/batch avg)")
    stats = service.stats()
    print(f"plan cache    {stats['plan_resident']} resident, "
          f"{stats['plan_cache']['hits']} hits / "
          f"{stats['plan_cache']['misses']} misses")
    print(f"warm cache    {stats['warm_cache']['served']} seeds served, "
          f"{stats['warm_cache']['stale']} stale, "
          f"{stats['warm_cache']['absent']} absent")


if __name__ == "__main__":
    main()
