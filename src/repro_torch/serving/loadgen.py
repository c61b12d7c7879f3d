"""Open-loop load generation for the matching service.

An *open-loop* generator submits on a fixed arrival process (Poisson at
``rate_rps``) regardless of how fast the service responds — the honest
way to measure serving latency, since a closed loop (wait for each
response before the next request) lets a slow service throttle its own
offered load and hide queueing delay. The stream models the paper's
motivating workload: a fixed population of users (factorization
pipelines), each re-requesting a matching for a *perturbed repeat* of
its own instance — weights jittered, occasionally an edge dropped — so
warm-start rematching has exactly the structure it exists to exploit.

The stream drives the service on a simulated clock (arrival times), so
throughput/latency numbers reflect the configured arrival process plus
the *measured* solve wall times, deterministically — not the vagaries of
host scheduling between submissions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import graph as _graph


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Shape of one open-loop run."""

    requests: int = 256
    users: int = 16  # distinct request keys (warm-cache identities)
    n: int = 48  # instance size per user
    avg_degree: float = 5.0
    rate_rps: float = 400.0  # Poisson arrival rate
    weight_jitter: float = 0.02  # relative weight perturbation per repeat
    structure_churn: float = 0.0  # P(drop one random edge) per repeat
    kind: str = "uniform"  # graph.generate family
    seed: int = 0

    def __post_init__(self):
        if self.requests < 1 or self.users < 1:
            raise ValueError("requests and users must be >= 1")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps!r}")


def perturbed(base: _graph.BipartiteGraph, rng: np.random.Generator,
              weight_jitter: float,
              structure_churn: float) -> _graph.BipartiteGraph:
    """A repeat of ``base``: same structure, jittered weights, and (with
    probability ``structure_churn``) one random edge dropped — the
    "slightly different instance next timestep" the warm path repairs."""
    nnz = base.nnz
    row = base.row[:nnz].copy()
    col = base.col[:nnz].copy()
    val = base.val[:nnz].astype(np.float64)
    if weight_jitter:
        val = np.abs(val * (1.0 + weight_jitter * rng.standard_normal(nnz)))
        val = np.maximum(val, 1e-6)  # keep weights positive
    if structure_churn and nnz > base.n and rng.random() < structure_churn:
        drop = int(rng.integers(0, nnz))
        keep = np.arange(nnz) != drop
        row, col, val = row[keep], col[keep], val[keep]
    return _graph.from_coo(row, col, val.astype(np.float32), base.n)


def _percentiles(latencies_s: np.ndarray) -> dict:
    if latencies_s.size == 0:
        return {"p50_us": 0.0, "p95_us": 0.0, "p99_us": 0.0}
    p50, p95, p99 = np.percentile(latencies_s, [50, 95, 99])
    return {"p50_us": float(p50 * 1e6), "p95_us": float(p95 * 1e6),
            "p99_us": float(p99 * 1e6)}


def run_stream(service, spec: StreamSpec) -> dict:
    """Drive ``service`` with one open-loop stream; return the summary.

    Returns a dict with the raw ``responses`` plus the headline numbers:
    served/rejected counts, warm/cold split, throughput (served requests
    per second of simulated stream time, solve wall included), latency
    percentiles, and mean batch fill.
    """
    rng = np.random.default_rng(spec.seed)
    bases = [_graph.generate(spec.n, spec.avg_degree, kind=spec.kind,
                             seed=spec.seed * 1009 + u)
             for u in range(spec.users)]
    arrivals = np.cumsum(rng.exponential(1.0 / spec.rate_rps,
                                         size=spec.requests))
    for i in range(spec.requests):
        u = i % spec.users
        g = perturbed(bases[u], rng, spec.weight_jitter,
                      spec.structure_churn)
        service.submit(f"user-{u}", g, now=float(arrivals[i]))
    end = float(arrivals[-1]) + service.batcher.deadline_s
    service.drain(now=end)
    responses = service.responses()
    served = [r for r in responses if r.ok]
    lat = np.array([r.latency_s for r in served])
    finish = max((r.completed_at for r in served), default=end)
    span = max(finish - float(arrivals[0]), 1e-9)
    summary = {
        "requests": spec.requests,
        "served": len(served),
        "rejected": len(responses) - len(served),
        "served_warm": sum(r.served_warm for r in served),
        "served_cold": sum(not r.served_warm for r in served),
        "degraded": sum(not r.result.perfect for r in served),
        "throughput_rps": len(served) / span,
        "mean_solve_us": float(np.mean([r.solve_s for r in served]) * 1e6)
        if served else 0.0,
        "mean_fill": float(np.mean([r.batch_fill for r in served]))
        if served else 0.0,
        "responses": responses,
    }
    summary.update(_percentiles(lat))
    return summary
