"""Matching-as-a-service tier (DESIGN.md §11): long-lived serving in
front of the ``core.api`` facade, on torch.

The paper's motivating workload — pivot orders for a stream of sparse
factorizations — arrives as many mostly-similar instances per second, not
one-shot calls. This package turns the plan-once/run-many ``Matcher``
into an actual service, whose solves run on the card (``device=None``)
unless the caller asks for the CPU:

  ``service``     request admission, consistent-hash shard routing,
                  size-class bucketing, batch dispatch (the front door:
                  :class:`MatchingService`).
  ``plan_cache``  LRU of pre-planned ``Matcher``s per size class with
                  hit/miss/eviction counters.
  ``batcher``     deadline batcher: pads requests into [B, cap] batches,
                  dispatching on batch-full or deadline expiry.
  ``warm``        warm-start seed cache + seed-or-cold fallback helper.
  ``loadgen``     open-loop (Poisson-arrival) load generator for the
                  ``python -m repro_torch.serving`` demo CLI and the chip
                  check's serving phase.
"""
from repro_torch.serving.batcher import DeadlineBatcher, Flush
from repro_torch.serving.loadgen import StreamSpec, run_stream
from repro_torch.serving.plan_cache import CacheStats, PlanCache
from repro_torch.serving.service import (
    MatchingService,
    Response,
    ServiceConfig,
    ShardRouter,
    SizeClass,
    embed_instance,
    size_class_for,
    strip_instance,
)
from repro_torch.serving.warm import (
    WarmStartCache,
    identity_mates,
    solve_with_seed,
)

__all__ = [
    "CacheStats",
    "DeadlineBatcher",
    "Flush",
    "MatchingService",
    "PlanCache",
    "Response",
    "ServiceConfig",
    "ShardRouter",
    "SizeClass",
    "StreamSpec",
    "WarmStartCache",
    "embed_instance",
    "identity_mates",
    "run_stream",
    "size_class_for",
    "solve_with_seed",
    "strip_instance",
]
