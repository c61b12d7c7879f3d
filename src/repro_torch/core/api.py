"""The public facade: one problem / options / result API over the single,
batched and distributed engines.

  - :class:`MatchingProblem` — the padded lex-sorted COO edge list as
    tensors ([cap] for one instance, [B, cap] for a batch) plus ``n``;
    constructors ``from_coo`` / ``from_graph`` / ``stack``.
  - :class:`SolveOptions` — a frozen, eagerly validated dataclass of the
    knobs (``max_iter``, ``min_gain``, ``backend``, ``window_steps``,
    ``grid``, ``cap``, ``a2a_caps``, ``packed``, ``on_invalid``,
    ``exchange_check``).
  - :func:`solve` — runs greedy maximal -> MCM -> AWAC on the problem's
    device, single or batched by the problem's shape, or on the 2D process
    grid of ``options.grid`` (``core.dist``), and returns a
    :class:`MatchResult`; ``warm_start=`` seeds it from an earlier
    matching (seed repair -> MCM top-up -> AWAC).
  - :func:`plan` -> :class:`Matcher` — the plan-once/run-many handle: the
    grid's per-block capacity, its bucket capacities, the pinned search
    depth and the engine are set up once, at plan time.

Problems live on the card unless the caller asks for the CPU
(``device="cpu"``); ``device=None`` means ``cuda``, and without a card it
raises instead of falling back. Every route and backend is bit-identical
per instance (mates, duals and iteration counts).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import batch as _batch
from repro_torch.core import dist as _dist
from repro_torch.core import graph as _graph
from repro_torch.core import preflight as _preflight
from repro_torch.core import single as _single
from repro_torch.core.constants import MIN_GAIN
from repro_torch.core.single import (
    KERNEL_BACKENDS,
    MatchState,
    resolve_device,
)
from repro_torch.kernels.backend import launch_counts
from repro_torch.sparse.csr import (
    batched_row_ptr_from_sorted,
    max_row_nnz,
    window_depth,
)
from repro_torch.sparse.partition import plan_block_cap

#: every backend ``SolveOptions`` accepts. "auto" runs the measured
#: dispatch table's winner for the problem's device and shape class
#: (``core.single.resolve_auto``); on a grid it means "fused", the
#: distributed exchange engine (grid only).
#: "cuda" launches the sweep kernel once per round. The two kernel
#: backends run their kernels' plain versions on a CPU problem;
#: "cuda_persistent" is local only, and "torch"/"cuda" with a grid need
#: the 1x1 grid (the block is the whole instance).
BACKENDS = ("auto", "reference", "torch", "cuda", "cuda_persistent",
            "fused")

#: ``SolveOptions.on_invalid`` policies (see ``core.preflight``).
ON_INVALID = ("raise", "sanitize", "degrade")

__all__ = [
    "BACKENDS",
    "MIN_GAIN",
    "ON_INVALID",
    "ExecutionInfo",
    "MatchResult",
    "Matcher",
    "MatchingProblem",
    "ProblemSpec",
    "SolveOptions",
    "plan",
    "resolve_device",
    "solve",
]


# --------------------------------------------------------------------------
# problem
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static shape signature of a :class:`MatchingProblem`."""

    n: int
    cap: int
    batch: int | None = None


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class MatchingProblem:
    """One (or a batch of) heavy-weight perfect-matching instance(s).

    ``row``/``col``/``val`` follow the repo-wide padded COO convention:
    lex-sorted by (row, col) per instance, padding entries (n, n, 0),
    square n x n, int32/int32/float32 tensors on one device. Shapes are
    [cap] (single instance) or [B, cap] (a batch sharing ``n``). Direct
    construction assumes that convention; use ``from_coo`` to sort/pad raw
    triples, ``from_graph`` for a ``BipartiteGraph``, and ``stack`` to
    batch instances of mixed nnz.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int

    def __post_init__(self):
        arrays = {"row": (self.row, torch.int32), "col": (self.col, torch.int32),
                  "val": (self.val, torch.float32)}
        for name, (x, dtype) in arrays.items():
            if not isinstance(x, torch.Tensor):
                raise TypeError(
                    f"{name} must be a torch.Tensor (see from_coo/from_graph/"
                    f"stack), got {type(x).__name__}")
            if x.dtype != dtype:
                raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        shp = tuple(self.row.shape)
        if tuple(self.col.shape) != shp or tuple(self.val.shape) != shp:
            raise ValueError(
                f"row/col/val shapes differ: {shp}, {tuple(self.col.shape)}, "
                f"{tuple(self.val.shape)}")
        if len(shp) not in (1, 2):
            raise ValueError(
                f"expected [cap] or [B, cap] edge arrays, got shape {shp}")
        if not (self.row.device == self.col.device == self.val.device):
            raise ValueError("row/col/val must lie on one device")
        object.__setattr__(self, "n", int(self.n))

    @property
    def device(self) -> torch.device:
        return self.row.device

    @property
    def is_batched(self) -> bool:
        return self.row.dim() == 2

    @property
    def batch_size(self) -> int | None:
        """B for a batched problem, None for a single instance."""
        return int(self.row.shape[0]) if self.is_batched else None

    @property
    def cap(self) -> int:
        """Padded edge capacity per instance."""
        return int(self.row.shape[-1])

    @property
    def spec(self) -> ProblemSpec:
        return ProblemSpec(n=self.n, cap=self.cap, batch=self.batch_size)

    @classmethod
    def from_coo(cls, row, col, val, n: int, capacity: int | None = None,
                 device=None) -> "MatchingProblem":
        """Sort raw COO triples lexicographically and pad to ``capacity``
        (rounded up to the repo-wide alignment when None)."""
        g = _graph.from_coo(row, col, val, n, capacity=capacity)
        return cls.from_graph(g, device=device)

    @classmethod
    def from_graph(cls, g: _graph.BipartiteGraph,
                   device=None) -> "MatchingProblem":
        dev = resolve_device(device)
        return cls(row=torch.from_numpy(g.row).to(dev),
                   col=torch.from_numpy(g.col).to(dev),
                   val=torch.from_numpy(g.val).to(dev), n=g.n)

    @classmethod
    def stack(cls, items: Sequence[Any], device=None) -> "MatchingProblem":
        """Pad instances (``BipartiteGraph``s or single-instance problems)
        of arbitrary per-instance nnz — but shared ``n`` — into one batched
        [B, cap] problem."""
        if not items:
            raise ValueError("stack() needs at least one instance")
        gs = []
        for it in items:
            if isinstance(it, _graph.BipartiteGraph):
                gs.append(it)
            elif isinstance(it, MatchingProblem):
                if it.is_batched:
                    raise ValueError(
                        "stack() takes single instances; got a batched "
                        f"problem of B={it.batch_size}")
                r = it.row.cpu().numpy()
                gs.append(_graph.BipartiteGraph(
                    n=it.n, nnz=int((r < it.n).sum()), row=r,
                    col=it.col.cpu().numpy(), val=it.val.cpu().numpy()))
            else:
                raise TypeError(
                    f"stack() takes BipartiteGraphs or MatchingProblems, "
                    f"got {type(it).__name__}")
        row, col, val = _batch.stack_graphs(gs, device=resolve_device(device))
        return cls(row=row, col=col, val=val, n=gs[0].n)


# --------------------------------------------------------------------------
# options
# --------------------------------------------------------------------------


def _as_int(message: str, v, minimum: int = 1) -> int:
    """Validate an integral knob (python or numpy int, bool excluded,
    >= minimum) and normalize it to a plain int."""
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)) \
            or v < minimum:
        raise ValueError(f"{message}, got {v!r}")
    return int(v)


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """The AWPM knobs, validated eagerly at construction.

    max_iter      AWAC round budget (>= 0; 0 skips refinement entirely).
    min_gain      minimum 4-cycle gain to count as augmenting (paper eps),
                  compared in float32.
    backend       one of :data:`BACKENDS`.
    window_steps  windowed-search depth override (None = measured; extra
                  depth never changes results, and an undersized override
                  is clamped up to the measured need).
    grid          None (local) or a ``core.dist.GridSpec`` (``make_grid``):
                  presence selects the distributed engine.
    cap           distributed per-block edge capacity override (None = the
                  true block occupancy, ``sparse.partition.plan_block_cap``;
                  too small raises "refusing to truncate" at partition
                  time: edges are never dropped silently).
    a2a_caps      distributed bucket capacities of the two exchange stages
                  (None = the drop-free ``dist.safe_a2a_caps``).
    packed        pack each distributed exchange into one collective.
    on_invalid    policy for degenerate input (``core.preflight``):
                  "raise" rejects fatal issues (non-finite weights,
                  duplicate edges) and infeasible instances with a typed
                  error; "sanitize" repairs the data but still raises on
                  infeasibility; "degrade" additionally returns the maximal
                  imperfect matching (``perfect=False``) with the diagnosis
                  attached. All three skip AWAC on infeasible instances.
    exchange_check  distributed only: count and checksum the two-stage
                  exchange every AWAC round; a drop, duplicate or
                  corruption raises ``core.dist.ExchangeIntegrityError``.
    """

    max_iter: int = 1000
    min_gain: float = MIN_GAIN
    backend: str = "auto"
    window_steps: int | None = None
    grid: Any = None
    cap: int | None = None
    a2a_caps: tuple[int, int] | None = None
    packed: bool = False
    on_invalid: str = "raise"
    exchange_check: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: expected one of "
                f"{BACKENDS}")
        if self.on_invalid not in ON_INVALID:
            raise ValueError(
                f"unknown on_invalid policy {self.on_invalid!r}: expected "
                f"one of {ON_INVALID}")
        object.__setattr__(
            self, "max_iter",
            _as_int("max_iter must be a non-negative int", self.max_iter,
                    minimum=0))
        if not math.isfinite(float(self.min_gain)) or float(self.min_gain) < 0:
            # negative values would admit zero/negative-gain 4-cycles and
            # let AWAC churn tie swaps for the whole max_iter budget
            raise ValueError(
                f"min_gain must be finite and >= 0, got {self.min_gain!r}")
        if self.window_steps is not None:
            object.__setattr__(
                self, "window_steps",
                _as_int("window_steps must be None or a positive int",
                        self.window_steps))
        if self.cap is not None:
            object.__setattr__(
                self, "cap",
                _as_int("cap must be None or a positive per-block edge "
                        "capacity", self.cap))
        if self.a2a_caps is not None:
            caps = tuple(self.a2a_caps)
            if len(caps) != 2:
                raise ValueError(
                    f"a2a_caps must be two positive ints (stage-1, stage-2 "
                    f"bucket capacities), got {self.a2a_caps!r}")
            object.__setattr__(self, "a2a_caps", tuple(
                _as_int("a2a_caps must be two positive ints", c)
                for c in caps))
        if self.grid is not None:
            spec = self.grid
            if not isinstance(spec, _dist.GridSpec):
                raise ValueError(
                    f"grid must be a repro_torch.core.dist.GridSpec (see "
                    f"make_grid), got {type(spec).__name__}")
            if self.backend == "cuda_persistent":
                raise ValueError(
                    "backend 'cuda_persistent' runs the whole AWAC loop "
                    "inside one local kernel and cannot take part in the "
                    "distributed exchange: drop SolveOptions.grid")
            if self.backend in ("torch", "cuda") and \
                    (spec.pr, spec.pc) != (1, 1):
                raise ValueError(
                    f"backend {self.backend!r} routes through the local "
                    f"sweep and needs the 1x1 grid, got "
                    f"{spec.pr}x{spec.pc}")
        else:
            if self.backend == "fused":
                raise ValueError(
                    "backend 'fused' is the distributed exchange engine and "
                    "requires SolveOptions.grid")
            for name in ("cap", "a2a_caps"):
                if getattr(self, name) is not None:
                    raise ValueError(
                        f"{name} is a distributed capacity knob and "
                        f"requires SolveOptions.grid")
            if self.packed:
                raise ValueError(
                    "packed is a distributed exchange knob and requires "
                    "SolveOptions.grid")
            if self.exchange_check:
                raise ValueError(
                    "exchange_check audits the distributed two-stage "
                    "exchange and requires SolveOptions.grid")

    def _dist_backend(self) -> str:
        return "fused" if self.backend == "auto" else self.backend


# --------------------------------------------------------------------------
# result
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionInfo:
    """How a solve actually executed.

    ``backend``: the concrete engine that ran (never "auto").
    ``source``: how the backend was chosen: "explicit" (user-pinned),
    "table" ("auto" resolved by the measured dispatch table,
    ``kernels.dispatch``, for the problem's device type and shape class),
    "heuristic" ("auto" where the table has no entry: the persistent
    kernel on the card, the plain torch sweep on the CPU) or
    "grid-default" ("auto" on a grid: the fused exchange engine).
    ``device``: the device the problem was solved on.
    ``ran_kernel``: for the kernel backends, True when a hand-written CUDA
    kernel was launched and False when its plain torch version ran (a CPU
    problem, or no AWAC round to run); None for the other backends.
    ``warm_started``: True when the solve was seeded from earlier mates
    (warm-start rematching) instead of greedy and MCM from scratch.
    """

    backend: str
    source: str
    device: str
    ran_kernel: bool | None = None
    warm_started: bool = False


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: tensor fields
class MatchResult:
    """Matching produced by :func:`solve`.

    Single instance: ``mate_row``/``mate_col`` are [n + 1] (sentinel slot
    n; ``mate_row[j]`` = row matched to column j), ``weight`` /
    ``awac_iters`` / ``perfect`` scalars. Batched: leading B on everything.
    ``diagnosis`` is a ``core.preflight.PreflightReport`` (or None) when
    preflight found issues worth surfacing — always present on a degraded
    (``perfect=False``) result. ``execution`` is an :class:`ExecutionInfo`.
    """

    mate_row: Any  # [n+1] or [B, n+1] int32; sentinel n = unmatched
    mate_col: Any  # [n+1] or [B, n+1] int32
    weight: Any  # matched-edge weight sum, f32
    awac_iters: Any  # AWAC rounds until convergence, i32
    perfect: Any  # bool: every column matched
    diagnosis: Any = None
    execution: Any = None


def _result(state, iters, n: int, batched: bool) -> MatchResult:
    if batched:
        weight = _batch.matching_weight_batched(state, n)
        perfect = _batch.is_perfect_batched(state, n)
    else:
        weight = _single.matching_weight(state, n)
        perfect = _single.is_perfect(state, n)
    return MatchResult(mate_row=state.mate_row, mate_col=state.mate_col,
                       weight=weight, awac_iters=iters, perfect=perfect)


# --------------------------------------------------------------------------
# solve
# --------------------------------------------------------------------------


def _check_types(problem, options):
    if not isinstance(problem, MatchingProblem):
        raise TypeError(
            f"solve() takes a MatchingProblem (see from_coo/from_graph/"
            f"stack), got {type(problem).__name__}")
    if not isinstance(options, SolveOptions):
        raise TypeError(
            f"options must be SolveOptions, got {type(options).__name__}")


def _apply_preflight(problem: MatchingProblem, options: SolveOptions):
    """Host-side input screening per ``options.on_invalid``. Returns the
    (possibly sanitized) problem and the report to carry into
    :func:`_finish`."""
    with obs.span("preflight"):
        report = _preflight.preflight(problem)
        if report.fatal:
            if options.on_invalid == "raise":
                raise _preflight.PreflightError(
                    report,
                    f"preflight rejected the problem: {report.summary()}. "
                    f"Pass SolveOptions(on_invalid='sanitize') to repair, or "
                    f"'degrade' to also accept infeasible instances.")
            problem, report = _preflight.sanitize(problem)
        if report.structural and options.on_invalid == "raise":
            # empty rows/columns make a perfect matching impossible — under
            # the strict policy that is an error, known before solving
            raise _preflight.InfeasibleProblemError(
                report,
                f"problem has no perfect matching: {report.summary()}. Pass "
                f"SolveOptions(on_invalid='degrade') for the maximal "
                f"matching.")
        return problem, report


def _finish(problem: MatchingProblem, result: MatchResult,
            options: SolveOptions, report) -> MatchResult:
    """Post-solve policy: attach the preflight diagnosis, and on an
    imperfect result either raise (raise/sanitize policies) or return the
    degraded matching with the deficiency folded into the diagnosis."""
    with obs.span("finish"):
        if obs.flag(result.perfect.all(), "finish"):
            if report is not None and report.issues:
                return dataclasses.replace(result, diagnosis=report)
            return result
        report = _preflight.deficiency_from_mates(
            result.mate_row, problem.n, report, batched=problem.is_batched)
        if options.on_invalid != "degrade":
            raise _preflight.InfeasibleProblemError(
                report,
                f"problem has no perfect matching: {report.summary()}. Pass "
                f"SolveOptions(on_invalid='degrade') for the maximal "
                f"matching.")
        return dataclasses.replace(result, diagnosis=report)


def _execution(problem: MatchingProblem, backend: str, source: str,
               launches_before: int, warm_started: bool) -> ExecutionInfo:
    ran = None
    if backend in KERNEL_BACKENDS:
        ran = sum(launch_counts().values()) > launches_before
    return ExecutionInfo(backend=backend, source=source,
                         device=str(problem.device), ran_kernel=ran,
                         warm_started=warm_started)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _warm_mates(problem: MatchingProblem, warm_start):
    """A warm-start seed as a (mate_row, mate_col) pair of [B, n] or
    [B, n + 1] tensors (a single instance's [n] or [n + 1] seed lifted to
    B = 1), from an earlier :class:`MatchResult` or a pair of arrays or
    tensors. A seed whose shape cannot belong to this problem raises
    ValueError (the serving tier then falls back to the cold path); entry
    values are not checked here: the engine's repair unmatches every stale
    or garbage pair."""
    if isinstance(warm_start, MatchResult):
        mr, mc = warm_start.mate_row, warm_start.mate_col
    elif isinstance(warm_start, (tuple, list)) and len(warm_start) == 2:
        mr, mc = warm_start
    else:
        raise TypeError(
            f"warm_start must be a MatchResult or a (mate_row, mate_col) "
            f"pair, got {type(warm_start).__name__}")
    n = problem.n
    shp = _shape(mr)
    if _shape(mc) != shp:
        raise ValueError(
            f"warm_start mate arrays disagree: {shp} vs {_shape(mc)}")
    if problem.is_batched:
        want = [(problem.batch_size, n), (problem.batch_size, n + 1)]
    else:
        want = [(n,), (n + 1,)]
    if shp not in want:
        raise ValueError(
            f"warm_start shape {shp} does not fit the problem (expected "
            f"one of {want}; stale seeds from a different n/batch must be "
            f"discarded, not repaired)")
    mr, mc = torch.as_tensor(mr), torch.as_tensor(mc)
    return (mr, mc) if problem.is_batched else (mr[None], mc[None])


def _lifted(problem: MatchingProblem):
    """The problem's edge arrays with a leading batch axis."""
    edges = (problem.row, problem.col, problem.val)
    return edges if problem.is_batched else tuple(x[None] for x in edges)


def solve(problem: MatchingProblem, options: SolveOptions | None = None, *,
          warm_start=None) -> MatchResult:
    """Run the full AWPM pipeline (greedy maximal -> MCM -> AWAC) on
    ``problem``: the single-instance engine for a [cap] problem, the
    batched engine for a [B, cap] one, on the problem's device; with
    ``options.grid``, the distributed engine on that process grid (a
    single instance lifted to B = 1), which every rank calls with the same
    problem. Returns a :class:`MatchResult`; bit-identical per instance on
    every route and backend.

    ``warm_start`` (an earlier :class:`MatchResult` or a (mate_row,
    mate_col) pair) seeds the pipeline from an earlier matching instead of
    greedy and MCM from scratch: stale pairs are repaired against the
    current edge list, a bounded MCM top-up closes the seed's deficiency
    and AWAC runs from there. The result is still a matching of this
    problem, and a seed that is already an AWAC fixed point of it comes
    back bit-identical. Each call is one call of the tracer
    (``repro_torch.obs``): its root span ``solve``."""
    with obs.span("solve"):
        return _solve(problem, options, warm_start)


def _solve(problem: MatchingProblem, options: SolveOptions | None,
           warm_start) -> MatchResult:
    options = SolveOptions() if options is None else options
    _check_types(problem, options)
    warm = None if warm_start is None else _warm_mates(problem, warm_start)
    problem, report = _apply_preflight(problem, options)
    if options.grid is not None:
        result = _solve_dist(problem, options, warm=warm)
        return _finish(problem, result, options, report)
    before = sum(launch_counts().values())
    if options.backend == "auto":
        backend, source = _single.resolve_auto(
            problem.device, n=problem.n, batch=problem.batch_size)
    else:
        backend, source = options.backend, "explicit"
    kw = dict(max_iter=options.max_iter, min_gain=options.min_gain,
              backend=backend, window_steps=options.window_steps,
              degrade_infeasible=True)
    if warm is None:
        engine = _batch._awpm_batched if problem.is_batched \
            else _single._awpm
        state, iters = engine(problem.row, problem.col, problem.val,
                              problem.n, **kw)
    else:
        # a single instance is lifted to B = 1: the batched engine is
        # bit-identical per instance to the single-instance one, so one
        # warm engine serves both
        state, iters = _batch._awpm_batched_from_state(
            *_lifted(problem), problem.n, *warm, **kw)
        if not problem.is_batched:
            state = MatchState(*(x[0] for x in state))
            iters = iters[0]
    result = _result(state, iters, problem.n, batched=problem.is_batched)
    result = dataclasses.replace(
        result, execution=_execution(problem, backend, source, before,
                                     warm is not None))
    return _finish(problem, result, options, report)


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``x``: one read of the device."""
    with obs.d2h("grid"):
        return x.cpu().numpy()


def _solve_dist(problem: MatchingProblem, options: SolveOptions,
                driver=None, warm=None) -> MatchResult:
    """Grid dispatch: the distributed-batched engine on ``options.grid``,
    a single instance lifted to B = 1. Every rank partitions the same
    problem on the host and runs its own block; the result is replicated
    on every rank. With a ``warm`` seed, the repair, the MCM top-up and
    the dual build run on the local batched engine, then one grid run
    takes AWAC from that state."""
    grid = options.grid
    if problem.device != grid.device:
        raise ValueError(
            f"the problem lies on {problem.device} but the grid runs on "
            f"{grid.device}")
    before = sum(launch_counts().values())
    state0 = None
    if warm is not None:
        edges = _lifted(problem)
        state0 = _batch._warm_state_batched(
            *edges, problem.n, *warm, batched_row_ptr_from_sorted(
                edges[0], problem.n),
            _batch._resolve_window_steps_batched(edges[0], problem.n,
                                                 options.window_steps))
    row, col, val = (_host_copy(x) for x in
                     (problem.row, problem.col, problem.val))
    batched = problem.is_batched
    if not batched:
        row, col, val = row[None], col[None], val[None]
    if driver is None:
        driver = _dist._DistBatchedAWPM(
            grid, problem.n, cap=options.cap, a2a_caps=options.a2a_caps,
            max_iter=options.max_iter, min_gain=options.min_gain,
            packed=options.packed, backend=options._dist_backend(),
            window_steps=options.window_steps, degrade_infeasible=True,
            exchange_check=options.exchange_check)
    state, iters, aux = driver.run(row, col, val, state=state0)
    # with exchange_check the engine sums a [dropped, integrity] pair;
    # otherwise aux is the plain global dropped counter
    with obs.d2h("grid_aux"):
        aux = aux.reshape(-1).tolist()
    dropped = aux[0]
    integrity = aux[1] if len(aux) > 1 else 0
    if integrity != 0:
        raise _dist.ExchangeIntegrityError(
            f"exchange integrity check failed on {integrity} AWAC round(s): "
            f"payloads received across the two-stage all_to_all do not "
            f"match what was sent (count or checksum mismatch). The "
            f"exchange lost, duplicated, or corrupted data; the result "
            f"cannot be trusted.")
    # only user-given a2a_caps can drop (the safe_a2a_caps default is
    # drop-free); a drop breaks the bit-identity contract, so it is an
    # error here, never a silent degradation
    if dropped != 0:
        raise _dist.ExchangeIntegrityError(
            f"{dropped} exchange requests were dropped by the "
            f"user-supplied a2a_caps={options.a2a_caps}: the result would "
            f"not be bit-identical to the local engines. Raise the bucket "
            f"capacities or leave a2a_caps=None for the drop-free default.")
    if not batched:
        state = MatchState(*(x[0] for x in state))
        iters = iters[0]
    result = _result(state, iters, problem.n, batched)
    source = "explicit" if options.backend != "auto" else "grid-default"
    return dataclasses.replace(result, execution=_execution(
        problem, options._dist_backend(), source, before, warm is not None))


# --------------------------------------------------------------------------
# plan: the plan-once/run-many Matcher
# --------------------------------------------------------------------------


class Matcher:
    """Solve handle specialized to one :class:`ProblemSpec` and options.

    All per-spec planning happens once, here: on a grid, the per-block
    capacity (the true occupancy via ``plan_block_cap`` when a prototype
    problem is given, the provable worst-case bound otherwise), drop-free
    bucket capacities, the pinned windowed-search depth and the engine's
    construction; locally, the pinned search depth, which spares each call
    its device read. Construct via :func:`plan`.
    """

    def __init__(self, problem_spec: ProblemSpec, options: SolveOptions,
                 prototype: MatchingProblem | None = None):
        self.problem_spec = problem_spec
        self.options = options
        grid = options.grid
        self._driver = None
        if grid is None:
            # pinned local search depth: covers any row (<= min(cap, n)
            # entries), and extra depth never changes a search result
            bound = window_depth(min(problem_spec.cap, problem_spec.n))
            self._window_steps = max(options.window_steps or 0, bound)
            self.block_cap = None
            self.a2a_caps = None
            return

        n, pr, pc = problem_spec.n, grid.pr, grid.pc
        if options.cap is not None:
            self.block_cap = options.cap
        elif prototype is not None:
            self.block_cap = plan_block_cap(
                prototype.row.cpu().numpy(), prototype.col.cpu().numpy(),
                n, pr, pc)
        else:
            # worst-case occupancy: a block never holds more than its dense
            # extent nor more than the instance's whole edge list
            br, bc = -(-n // pr), -(-n // pc)
            self.block_cap = max(8, min(problem_spec.cap, br * bc))
        self.a2a_caps = options.a2a_caps or _dist.safe_a2a_caps(
            self.block_cap, pr, pc)
        # the pin is lifted to the prototype's widest row (a block's row
        # holds no more), or else to the block bound: a problem like the
        # prototype keeps the pin and uses the plan-time engine. A wider
        # row lifts the depth and builds another engine, with the same
        # results; every search round costs a pass over the block.
        need = self.block_cap if prototype is None else max_row_nnz(
            prototype.row, n)
        self._window_steps = max(options.window_steps or 0,
                                 window_depth(need))
        self._driver = _dist._DistBatchedAWPM(
            grid, n, cap=self.block_cap, a2a_caps=self.a2a_caps,
            max_iter=options.max_iter, min_gain=options.min_gain,
            packed=options.packed, backend=options._dist_backend(),
            window_steps=self._window_steps,
            degrade_infeasible=True, exchange_check=options.exchange_check)
        # build the engine now; the call mirrors _DistBatchedAWPM.run, so
        # the first call finds it in the engine cache
        _dist._make_awpm_dist_batched(
            grid, n, problem_spec.batch or 1, self.block_cap, self.a2a_caps,
            options.max_iter, options.min_gain, packed=options.packed,
            backend=options._dist_backend(), window_steps=self._window_steps,
            from_state=False, degrade_infeasible=True,
            exchange_check=options.exchange_check)

    def _check(self, problem: MatchingProblem):
        spec = self.problem_spec
        if not isinstance(problem, MatchingProblem):
            raise TypeError(
                f"Matcher takes a MatchingProblem, got "
                f"{type(problem).__name__}")
        if problem.n != spec.n or problem.batch_size != spec.batch:
            raise ValueError(
                f"problem (n={problem.n}, batch={problem.batch_size}) does "
                f"not match the planned spec (n={spec.n}, "
                f"batch={spec.batch})")
        if problem.cap != spec.cap:
            raise ValueError(
                f"problem cap {problem.cap} != planned cap {spec.cap} "
                f"(the plan is shape-specialized; re-plan() or pad to the "
                f"planned capacity)")

    def __call__(self, problem: MatchingProblem,
                 warm_start=None) -> MatchResult:
        self._check(problem)
        opts = self.options
        if self._driver is None:
            pinned = dataclasses.replace(opts,
                                         window_steps=self._window_steps)
            return solve(problem, pinned, warm_start=warm_start)
        warm = None if warm_start is None \
            else _warm_mates(problem, warm_start)
        problem, report = _apply_preflight(problem, opts)
        try:
            result = _solve_dist(problem, opts, driver=self._driver,
                                 warm=warm)
        except ValueError as e:
            if "refusing to truncate" not in str(e):
                raise
            # a prototype-planned capacity is the prototype's TRUE
            # occupancy (no headroom): denser same-spec data needs a bigger
            # plan, not the partition's own advice
            raise ValueError(
                f"problem exceeds the planned per-block capacity "
                f"(block_cap={self.block_cap}): {e}. plan() again with "
                f"a denser prototype, or pass SolveOptions(cap=...) "
                f"with headroom for the serving workload.") from e
        return _finish(problem, result, opts, report)

    def __repr__(self):
        mode = "local" if self._driver is None else (
            f"grid {self.options.grid.pr}x{self.options.grid.pc}, "
            f"block_cap={self.block_cap}, a2a_caps={self.a2a_caps}")
        return (f"Matcher(n={self.problem_spec.n}, "
                f"cap={self.problem_spec.cap}, "
                f"batch={self.problem_spec.batch}, "
                f"backend={self.options.backend!r}, {mode}, "
                f"window_steps={self._window_steps})")


def plan(problem_spec: ProblemSpec | MatchingProblem,
         options: SolveOptions | None = None) -> Matcher:
    """Build a :class:`Matcher` for ``problem_spec`` (a :class:`ProblemSpec`,
    or a prototype :class:`MatchingProblem`, which lets the grid's
    capacity planning measure the TRUE block occupancy instead of the
    worst-case bound). Plan time: capacity and bucket planning, the search
    depth's pin, the engine's construction. Call time: preflight, the
    partition and the engine's run."""
    options = SolveOptions() if options is None else options
    if not isinstance(options, SolveOptions):
        raise TypeError(
            f"options must be SolveOptions, got {type(options).__name__}")
    prototype = None
    if isinstance(problem_spec, MatchingProblem):
        prototype = problem_spec
        problem_spec = problem_spec.spec
    elif not isinstance(problem_spec, ProblemSpec):
        raise TypeError(
            f"plan() takes a ProblemSpec or a prototype MatchingProblem, "
            f"got {type(problem_spec).__name__}")
    return Matcher(problem_spec, options, prototype=prototype)
