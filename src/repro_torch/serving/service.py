"""The matching service front door: admission -> routing -> size-class
bucketing -> deadline batching -> batched (warm or cold) dispatch.

Request path (DESIGN.md §11):

  1. **Admission** — the instance is embedded into its size class and
     preflighted (``core.preflight``). Fatal data issues (NaN weights,
     duplicate edges) are sanitized (default) or rejected per
     ``ServiceConfig.admission``; structurally infeasible instances are
     admitted and served *degraded* — dispatch always runs with
     ``on_invalid="degrade"`` so one poisoned instance yields its own
     imperfect result instead of stalling (or poisoning) its batchmates.
  2. **Routing** — the request key is consistent-hashed to a shard
     (:class:`ShardRouter`, SNIPPETS.md §2 idiom). Shards model the units
     a real deployment would scale across: each shard has its own warm
     cache and its own batches (requests never co-batch across shards).
  3. **Size-class bucketing** — (n, nnz) maps onto a power-of-two ladder
     (:func:`size_class_for`): n is embedded up to the class n with
     degree-1 dummy diagonal edges of weight 0 (provably inert — a
     degree-1 row can never participate in a 4-cycle, and weight 0 adds
     nothing), cap is the padded-COO capacity. Bounding distinct classes
     bounds the planned matchers kept alive; an oversize instance gets an
     exact class of batch 1 (dispatching immediately) rather than an
     unbounded padded one.
  4. **Deadline batching** — per (shard, class) queues fill [B, cap]
     batches until full or deadline (``serving.batcher``).
  5. **Dispatch** — the class's planned matcher comes from the LRU
     ``PlanCache``; the batch splits into a cold lane and a warm lane
     (requests holding a seed from the shard's ``WarmStartCache``), each
     padded to B with identity filler instances. A lane's instances and
     seeds are stacked on the host and go to the service's device in one
     copy each; the result comes back in one copy, is stripped back to
     each caller's true n, and the fresh mates re-seed the warm cache.

Admission, queues, caches and the stripped results live on the host
(numpy); only a lane's solve runs on the device (the card unless the
service is built with ``device="cpu"``), through ``plan()``/``Matcher``
and ``solve()`` with the options' backend ("auto": the persistent AWAC
kernel on the card).

Time is injected everywhere (``now=`` / a ``clock`` callable) so tests
and the open-loop load generator drive a simulated clock through the
exact production code path; only the solve itself is measured on the real
clock, ending in a synchronize of the service's device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import api as _api
from repro_torch.core import graph as _graph
from repro_torch.core import preflight as _preflight
from repro_torch.serving.batcher import DeadlineBatcher, Flush
from repro_torch.serving.plan_cache import PlanCache
from repro_torch.serving.warm import WarmStartCache, identity_mates

_ALIGN = 8  # repo-wide COO pad alignment (graph.from_coo default)

#: admission policies for fatal preflight issues (non-finite weights,
#: duplicate edges): repair the data in place, or refuse the request.
ADMISSION = ("sanitize", "reject")


def _pow2_at_least(x: int, floor: int) -> int:
    x = max(int(x), int(floor), 1)
    return 1 << (x - 1).bit_length()


# --------------------------------------------------------------------------
# size classes + embedding
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class SizeClass:
    """One bucket of the class ladder: instances embedded to ``n`` with
    edge capacity ``cap``, batched up to ``batch`` per dispatch."""

    n: int
    cap: int
    batch: int

    def __post_init__(self):
        if self.cap < self.n:
            raise ValueError(
                f"cap {self.cap} < n {self.n}: the class cannot hold its "
                f"own identity filler")


def size_class_for(n: int, nnz: int, *, min_class_n: int = 32,
                   max_class_n: int = 4096,
                   max_batch: int = 8) -> SizeClass:
    """Map an instance's (n, nnz) to its size class.

    Both n and cap ride a power-of-two ladder, so the number of distinct
    classes — and therefore planned matchers — grows logarithmically in
    the traffic's size spread. ``cap`` always covers the embedded edge
    count (nnz real + (class n - n) dummies) AND a full identity diagonal,
    so filler instances and infeasible-but-admitted instances always fit.
    An instance over ``max_class_n`` is served exactly (no embedding) in
    its own batch-1 class: padding it to the next power of two would cost
    more than the class it saves.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if nnz < 0:
        raise ValueError(f"nnz must be >= 0, got {nnz}")
    if n > max_class_n:
        cap = max(_ALIGN, -(-max(nnz, n) // _ALIGN) * _ALIGN)
        return SizeClass(n=n, cap=cap, batch=1)
    n_class = _pow2_at_least(n, min_class_n)
    need = max(nnz + (n_class - n), n_class)
    return SizeClass(n=n_class, cap=_pow2_at_least(need, _ALIGN),
                     batch=max_batch)


def _host(x) -> np.ndarray:
    """A numpy view or copy of a tensor (on any device) or an array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _real_edges(problem) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Unpack the real (non-padding) COO triples of a single instance
    (``BipartiteGraph`` or unbatched ``MatchingProblem``), on the host."""
    if isinstance(problem, _graph.BipartiteGraph):
        n = problem.n
        row = np.asarray(problem.row, np.int32)
        col = np.asarray(problem.col, np.int32)
        val = np.asarray(problem.val, np.float32)
    elif isinstance(problem, _api.MatchingProblem):
        if problem.is_batched:
            raise ValueError(
                "the service batches for you — submit single instances, "
                f"got a batch of B={problem.batch_size}")
        n = problem.n
        row = _host(problem.row).astype(np.int32, copy=False)
        col = _host(problem.col).astype(np.int32, copy=False)
        val = _host(problem.val).astype(np.float32, copy=False)
    else:
        raise TypeError(
            f"submit() takes a BipartiteGraph or MatchingProblem, got "
            f"{type(problem).__name__}")
    real = row < n
    return row[real], col[real], val[real], int(n)


def embed_instance(problem, cls: SizeClass,
                   device=None) -> _api.MatchingProblem:
    """Embed a single instance into its size class: real edges plus a
    weight-0 dummy diagonal on rows/columns [n, class n). Dummies are
    degree-1 (their row and column carry exactly that one edge), so no
    4-cycle can route through them and the matching weight over real
    edges is untouched; the embedded instance is feasible iff the
    original is. The problem is built on ``device`` (None: the card); the
    service keeps it on the host."""
    row, col, val, n = _real_edges(problem)
    if n > cls.n:
        raise ValueError(f"instance n={n} exceeds class n={cls.n}")
    extra = cls.n - n
    if extra:
        dummy = np.arange(n, cls.n, dtype=np.int32)
        row = np.concatenate([row, dummy])
        col = np.concatenate([col, dummy])
        val = np.concatenate([val, np.zeros(extra, np.float32)])
    if row.shape[0] > cls.cap:
        raise ValueError(
            f"embedded nnz {row.shape[0]} exceeds class cap {cls.cap}")
    g = _graph.from_coo(row, col, val, cls.n, capacity=cls.cap)
    return _api.MatchingProblem.from_graph(g, device=device)


def strip_instance(result: _api.MatchResult, index: int | None, n: int,
                   n_class: int) -> _api.MatchResult:
    """Undo the class embedding for one instance of a (batched) class
    result: slice mates back to [n + 1], remapping anything matched
    outside the real range (the class sentinel, or nothing at all for a
    degraded instance) to the sentinel n. Dummy edges weigh 0, so the
    reported weight is already the real-edge weight; ``perfect`` is
    recomputed over the real columns only. The stripped result holds numpy
    arrays (a result on the device is copied to the host field by field;
    the service hands in a host copy)."""
    def pick(x):
        a = _host(x)
        return a[index] if index is not None else a

    mr_full, mc_full = pick(result.mate_row), pick(result.mate_col)
    mr = np.full(n + 1, n, np.int32)
    mc = np.full(n + 1, n, np.int32)
    mr[:n] = np.where(mr_full[:n] < n, mr_full[:n], n)
    mc[:n] = np.where(mc_full[:n] < n, mc_full[:n], n)
    return _api.MatchResult(
        mate_row=mr, mate_col=mc,
        weight=np.float32(pick(result.weight)),
        awac_iters=np.int32(pick(result.awac_iters)),
        perfect=bool((mr[:n] < n).all()),
        diagnosis=result.diagnosis, execution=result.execution)


# --------------------------------------------------------------------------
# consistent-hash shard routing
# --------------------------------------------------------------------------


class ShardRouter:
    """Consistent-hash routing of request keys onto shards.

    Keys hash into ``2**n_bits`` stable slots; slots map onto the current
    shard count by modulo. The two-level scheme (slots, then shards) is
    the standard trick: a key's *slot* never changes, so growing the
    shard fleet remaps only slots, not the hash space. blake2b rather
    than ``hash()`` because routing must be deterministic across
    processes and runs (PYTHONHASHSEED randomizes ``hash`` per process —
    a warm cache keyed by process-local routing would go cold on every
    restart).
    """

    def __init__(self, num_shards: int, n_bits: int = 12):
        if not isinstance(num_shards, int) or num_shards < 1:
            raise ValueError(
                f"num_shards must be a positive int, got {num_shards!r}")
        if not isinstance(n_bits, int) or n_bits < 1:
            raise ValueError(
                f"n_bits must be a positive int, got {n_bits!r}")
        self.num_shards = num_shards
        self.n_bits = n_bits
        self.total_slots = 1 << n_bits

    def slot_for(self, key: str) -> int:
        digest = hashlib.blake2b(key.encode("utf-8"),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big") % self.total_slots

    def shard_for(self, key: str) -> int:
        return self.slot_for(key) % self.num_shards

    def slots_for_shard(self, shard: int) -> list[int]:
        if not 0 <= shard < self.num_shards:
            raise ValueError(
                f"shard must be in [0, {self.num_shards - 1}], got {shard}")
        return [s for s in range(self.total_slots)
                if s % self.num_shards == shard]


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service knobs. ``options`` owns the algorithm (a ``SolveOptions``;
    its ``on_invalid`` is forced to "degrade" at dispatch — see module
    docstring); everything else owns the serving shape."""

    num_shards: int = 4
    deadline_s: float = 0.002
    max_batch: int = 8
    min_class_n: int = 32
    max_class_n: int = 4096
    plan_capacity: int = 32
    warm_capacity: int = 4096
    warm_start: bool = True
    admission: str = "sanitize"
    options: Any = None  # SolveOptions | None
    resilient: bool = False  # serve through runtime.resilient rung chains
    resilience: Any = None  # ResilientOptions | None (resilient=True only)

    def __post_init__(self):
        if self.admission not in ADMISSION:
            raise ValueError(
                f"unknown admission policy {self.admission!r}: expected "
                f"one of {ADMISSION}")
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch!r}")


@dataclasses.dataclass
class _Request:
    """One admitted request, queued for dispatch."""

    request_id: int
    key: str
    shard: int
    size_class: SizeClass
    n: int  # true instance size (pre-embedding)
    problem: _api.MatchingProblem  # embedded at class padding
    seed: tuple | None  # class-padded (mate_row, mate_col) or None
    submitted_at: float
    admission_note: str | None  # sanitize summary when admission repaired


@dataclasses.dataclass(frozen=True)
class Response:
    """What the caller gets back for one request."""

    request_id: int
    key: str
    shard: int
    size_class: SizeClass
    ok: bool  # False only for rejected admissions
    result: Any  # stripped MatchResult | None when rejected
    error: str | None
    served_warm: bool  # solved from a warm seed
    lane: str  # "warm" | "cold" | "rejected"
    batch_fill: int  # real requests in the dispatched batch
    flush_reason: str  # "full" | "deadline" | "drain" | "rejected"
    submitted_at: float
    dispatched_at: float
    completed_at: float
    solve_s: float  # measured batch solve wall time
    latency_s: float  # queueing delay + solve
    resilience: str | None = None  # ResilienceReport.summary() if resilient


class MatchingService:
    """Long-lived matching service over ``core.api`` (module docstring).

    Drive it with ``submit`` (admission + routing + queueing; dispatches
    any batch the submission filled or expired), ``pump`` (dispatch
    deadline-expired batches — an event loop would call this at
    ``batcher.next_deadline()``), ``drain`` (flush everything), and
    ``responses`` (pop completed responses). Single-threaded by design:
    determinism is a feature here, and the solves themselves already
    saturate the device. The solves run on ``device``: None means the
    card, and without one the constructor raises unless the caller asks
    for ``device="cpu"``.
    """

    def __init__(self, config: ServiceConfig | None = None,
                 clock=time.monotonic, device=None):
        self.config = config or ServiceConfig()
        cfg = self.config
        self.device = _api.resolve_device(device)
        opts = cfg.options or _api.SolveOptions()
        if not isinstance(opts, _api.SolveOptions):
            raise TypeError(
                f"config.options must be SolveOptions or None, got "
                f"{type(opts).__name__}")
        # degrade, never raise, inside a batch: a poisoned instance gets
        # its own imperfect result; its batchmates are untouched
        self._options = dataclasses.replace(opts, on_invalid="degrade")
        self.router = ShardRouter(cfg.num_shards)
        self.plans = PlanCache(cfg.plan_capacity)
        self.batcher = DeadlineBatcher(cfg.deadline_s)
        self.warm_caches = [WarmStartCache(cfg.warm_capacity)
                            for _ in range(cfg.num_shards)]
        self._clock = clock
        self._next_id = 0
        self._completed: list[Response] = []
        self._fillers: dict[SizeClass, _api.MatchingProblem] = {}
        self.counters = {
            "submitted": 0, "rejected": 0, "served": 0, "served_warm": 0,
            "served_cold": 0, "flushes": 0, "fill_sum": 0, "degraded": 0,
        }

    # ---- admission ----

    def submit(self, key: str, problem, now: float | None = None) -> int:
        """Admit one instance under ``key`` (the caller's stable identity
        — warm seeds and shard affinity follow it). Returns the request
        id; the response arrives via ``responses()`` after the batch
        holding it dispatches."""
        now = self._clock() if now is None else now
        rid = self._next_id
        self._next_id += 1
        self.counters["submitted"] += 1
        cfg = self.config
        row, col, val, n = _real_edges(problem)
        cls = size_class_for(
            n, int(row.shape[0]), min_class_n=cfg.min_class_n,
            max_class_n=cfg.max_class_n, max_batch=cfg.max_batch)
        shard = self.router.shard_for(key)
        embedded = embed_instance(problem, cls, device="cpu")
        note = None
        report = _preflight.preflight(embedded)
        if report.fatal:
            if cfg.admission == "reject":
                self.counters["rejected"] += 1
                self._completed.append(Response(
                    request_id=rid, key=key, shard=shard, size_class=cls,
                    ok=False, result=None,
                    error=f"admission rejected: {report.summary()}",
                    served_warm=False, lane="rejected", batch_fill=0,
                    flush_reason="rejected", submitted_at=now,
                    dispatched_at=now, completed_at=now, solve_s=0.0,
                    latency_s=0.0))
                return rid
            embedded, report = _preflight.sanitize(embedded)
            note = f"sanitized at admission: {report.summary()}"
        seed = None
        if cfg.warm_start:
            seed = self.warm_caches[shard].seed_for(key, cls.n)
        req = _Request(request_id=rid, key=key, shard=shard, size_class=cls,
                       n=n, problem=embedded, seed=seed, submitted_at=now,
                       admission_note=note)
        flush = self.batcher.add((shard, cls), req, now, cls.batch)
        if flush is not None:
            self._dispatch(flush)
        self.pump(now)
        return rid

    # ---- dispatch ----

    def pump(self, now: float | None = None) -> None:
        """Dispatch every deadline-expired batch."""
        now = self._clock() if now is None else now
        for flush in self.batcher.due(now):
            self._dispatch(flush)

    def drain(self, now: float | None = None) -> None:
        """Dispatch everything still queued (end of stream/shutdown)."""
        now = self._clock() if now is None else now
        for flush in self.batcher.drain(now):
            self._dispatch(flush)

    def responses(self) -> list[Response]:
        """Pop all completed responses (submission order within a batch)."""
        out, self._completed = self._completed, []
        return out

    def stats(self) -> dict:
        """Operator snapshot: counters + cache stats."""
        out = dict(self.counters)
        out["plan_cache"] = dataclasses.asdict(self.plans.stats)
        out["plan_resident"] = len(self.plans)
        out["warm_cache"] = {
            "served": sum(c.stats.served for c in self.warm_caches),
            "stale": sum(c.stats.stale for c in self.warm_caches),
            "absent": sum(c.stats.absent for c in self.warm_caches),
        }
        if out["flushes"]:
            out["avg_fill"] = out["fill_sum"] / out["flushes"]
        return out

    def _matcher(self, cls: SizeClass):
        spec = _api.ProblemSpec(n=cls.n, cap=cls.cap, batch=cls.batch)
        if self.config.resilient:
            from repro_torch.runtime import resilient as _resilient

            def build():
                return _resilient.ResilientMatcher(
                    spec, self._options, self.config.resilience,
                    device=self.device)
        else:
            def build():
                return _api.plan(spec, self._options)
        return self.plans.get((cls.n, cls.cap, cls.batch), build)

    def _filler(self, cls: SizeClass) -> _api.MatchingProblem:
        """The identity filler instance for ``cls`` on the host:
        unit-weight diagonal, trivially solvable, padding warm and cold
        lanes alike."""
        f = self._fillers.get(cls)
        if f is None:
            eye = np.arange(cls.n, dtype=np.int32)
            f = _api.MatchingProblem.from_graph(_graph.from_coo(
                eye, eye, np.ones(cls.n, np.float32), cls.n,
                capacity=cls.cap), device="cpu")
            self._fillers[cls] = f
        return f

    def _dispatch(self, flush: Flush) -> None:
        shard, cls = flush.key
        self.counters["flushes"] += 1
        self.counters["fill_sum"] += len(flush.items)
        warm_lane = [r for r in flush.items if r.seed is not None]
        cold_lane = [r for r in flush.items if r.seed is None]
        for lane, reqs in (("cold", cold_lane), ("warm", warm_lane)):
            if reqs:
                self._run_lane(lane, reqs, cls, shard, flush)

    def _run_lane(self, lane: str, reqs: list, cls: SizeClass, shard: int,
                  flush: Flush) -> None:
        filler = self._filler(cls)
        pad = cls.batch - len(reqs)
        probs = [r.problem for r in reqs] + [filler] * pad
        # the lane's [3, B, cap] edges, stacked on the host (the weights'
        # float32 bits ride as int32), reach the device in one copy
        edges = torch.from_numpy(np.stack([
            np.stack([p.row.numpy() for p in probs]),
            np.stack([p.col.numpy() for p in probs]),
            np.stack([p.val.numpy() for p in probs]).view(np.int32),
        ])).to(self.device)
        batch = _api.MatchingProblem(row=edges[0], col=edges[1],
                                     val=edges[2].view(torch.float32),
                                     n=cls.n)
        seed = None
        if lane == "warm":
            ident = identity_mates(cls.n)
            mates = torch.from_numpy(np.stack([
                np.stack([r.seed[0] for r in reqs] + [ident[0]] * pad),
                np.stack([r.seed[1] for r in reqs] + [ident[1]] * pad),
            ])).to(self.device)
            seed = (mates[0], mates[1])
        matcher = self._matcher(cls)
        t0 = time.perf_counter()
        served = matcher(batch) if seed is None \
            else matcher(batch, warm_start=seed)
        resilience = None
        if self.config.resilient:  # ResilientResult: unwrap + keep story
            resilience = served.report.summary()
            result = served.result
        else:
            result = served
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        solve_s = time.perf_counter() - t0
        completed_at = flush.dispatched_at + solve_s
        result = _result_to_host(result)
        mr_all, mc_all = result.mate_row, result.mate_col
        for i, r in enumerate(reqs):
            stripped = strip_instance(result, i, r.n, cls.n)
            if self.config.warm_start:
                self.warm_caches[shard].put(r.key, cls.n, mr_all[i],
                                            mc_all[i])
            self.counters["served"] += 1
            self.counters[f"served_{lane}"] += 1
            if not stripped.perfect:
                self.counters["degraded"] += 1
            error = r.admission_note
            self._completed.append(Response(
                request_id=r.request_id, key=r.key, shard=shard,
                size_class=cls, ok=True, result=stripped, error=error,
                served_warm=lane == "warm", lane=lane,
                batch_fill=len(reqs), flush_reason=flush.reason,
                submitted_at=r.submitted_at,
                dispatched_at=flush.dispatched_at,
                completed_at=completed_at, solve_s=solve_s,
                latency_s=completed_at - r.submitted_at,
                resilience=resilience))


def _result_to_host(result: _api.MatchResult) -> _api.MatchResult:
    """A batched result with numpy fields, from one device-to-host copy of
    its mates, rounds, weights and flags packed as int32 words."""
    mr, mc = result.mate_row, result.mate_col
    width = mr.shape[1]
    words = torch.cat([
        mr, mc, result.awac_iters.to(torch.int32)[:, None],
        result.weight.to(torch.float32).view(torch.int32)[:, None],
        result.perfect.to(torch.int32)[:, None]], dim=1).cpu().numpy()
    return dataclasses.replace(
        result, mate_row=words[:, :width], mate_col=words[:, width:2 * width],
        awac_iters=words[:, 2 * width],
        weight=words[:, 2 * width + 1].view(np.float32),
        perfect=words[:, 2 * width + 2].astype(bool))
