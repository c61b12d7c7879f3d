"""The public facade: one problem / options / result API over the single
and batched engines.

  - :class:`MatchingProblem` — the padded lex-sorted COO edge list as
    tensors ([cap] for one instance, [B, cap] for a batch) plus ``n``;
    constructors ``from_coo`` / ``from_graph`` / ``stack``.
  - :class:`SolveOptions` — a frozen, eagerly validated dataclass of the
    knobs (``max_iter``, ``min_gain``, ``backend``, ``window_steps``,
    ``on_invalid``).
  - :func:`solve` — runs greedy maximal -> MCM -> AWAC on the problem's
    device, single or batched by the problem's shape, and returns a
    :class:`MatchResult`.

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

from repro_torch.core import batch as _batch
from repro_torch.core import graph as _graph
from repro_torch.core import preflight as _preflight
from repro_torch.core import single as _single
from repro_torch.core.constants import MIN_GAIN
from repro_torch.core.single import resolve_device
from repro_torch.kernels.backend import launch_counts

#: every backend ``SolveOptions`` accepts. "auto" runs the persistent CUDA
#: kernel for a problem on the card and the plain torch sweep on the CPU.
#: "cuda" launches the sweep kernel once per round. The two kernel
#: backends run their kernels' plain versions on a CPU problem.
BACKENDS = ("auto", "reference", "torch", "cuda", "cuda_persistent")

#: backends that launch a hand-written kernel for a problem on the card
KERNEL_BACKENDS = ("cuda", "cuda_persistent")

#: ``SolveOptions.on_invalid`` policies (see ``core.preflight``).
ON_INVALID = ("raise", "sanitize", "degrade")

__all__ = [
    "BACKENDS",
    "MIN_GAIN",
    "ON_INVALID",
    "ExecutionInfo",
    "MatchResult",
    "MatchingProblem",
    "ProblemSpec",
    "SolveOptions",
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
    grid          the 2D process grid of the distributed engine. Not
                  ported yet: anything but None raises NotImplementedError.
    on_invalid    policy for degenerate input (``core.preflight``):
                  "raise" rejects fatal issues (non-finite weights,
                  duplicate edges) and infeasible instances with a typed
                  error; "sanitize" repairs the data but still raises on
                  infeasibility; "degrade" additionally returns the maximal
                  imperfect matching (``perfect=False``) with the diagnosis
                  attached. All three skip AWAC on infeasible instances.
    """

    max_iter: int = 1000
    min_gain: float = MIN_GAIN
    backend: str = "auto"
    window_steps: int | None = None
    grid: Any = None
    on_invalid: str = "raise"

    def __post_init__(self):
        if self.grid is not None:
            raise NotImplementedError(
                "SolveOptions.grid: the 2D-grid distributed engine is not "
                "ported to torch yet (ROADMAP.md, Queue 1, item 6)")
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


# --------------------------------------------------------------------------
# result
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionInfo:
    """How a solve actually executed.

    ``backend``: the concrete engine that ran (never "auto").
    ``source``: "explicit" (user-pinned) or "default" ("auto" resolved by
    the problem's device; the port has no measured dispatch table yet).
    ``device``: the device the problem was solved on.
    ``ran_kernel``: for the kernel backends, True when a hand-written CUDA
    kernel was launched and False when its plain torch version ran (a CPU
    problem, or no AWAC round to run); None for the other backends.
    """

    backend: str
    source: str
    device: str
    ran_kernel: bool | None = None


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
    report = _preflight.preflight(problem)
    if report.fatal:
        if options.on_invalid == "raise":
            raise _preflight.PreflightError(
                report,
                f"preflight rejected the problem: {report.summary()}. Pass "
                f"SolveOptions(on_invalid='sanitize') to repair, or "
                f"'degrade' to also accept infeasible instances.")
        problem, report = _preflight.sanitize(problem)
    if report.structural and options.on_invalid == "raise":
        # empty rows/columns make a perfect matching impossible — under the
        # strict policy that is an error, and it is known before solving
        raise _preflight.InfeasibleProblemError(
            report,
            f"problem has no perfect matching: {report.summary()}. Pass "
            f"SolveOptions(on_invalid='degrade') for the maximal matching.")
    return problem, report


def _finish(problem: MatchingProblem, result: MatchResult,
            options: SolveOptions, report) -> MatchResult:
    """Post-solve policy: attach the preflight diagnosis, and on an
    imperfect result either raise (raise/sanitize policies) or return the
    degraded matching with the deficiency folded into the diagnosis."""
    if bool(result.perfect.all()):
        if report is not None and report.issues:
            return dataclasses.replace(result, diagnosis=report)
        return result
    report = _preflight.deficiency_from_mates(
        result.mate_row, problem.n, report, batched=problem.is_batched)
    if options.on_invalid != "degrade":
        raise _preflight.InfeasibleProblemError(
            report,
            f"problem has no perfect matching: {report.summary()}. Pass "
            f"SolveOptions(on_invalid='degrade') for the maximal matching.")
    return dataclasses.replace(result, diagnosis=report)


def solve(problem: MatchingProblem, options: SolveOptions | None = None, *,
          warm_start=None) -> MatchResult:
    """Run the full AWPM pipeline (greedy maximal -> MCM -> AWAC) on
    ``problem``, on the problem's device: the single-instance engine for a
    [cap] problem, the batched engine for a [B, cap] one. Returns a
    :class:`MatchResult`; bit-identical per instance on every route and
    backend.

    ``warm_start`` (seeding from an earlier matching) is not ported yet
    and raises NotImplementedError."""
    options = SolveOptions() if options is None else options
    _check_types(problem, options)
    if warm_start is not None:
        raise NotImplementedError(
            "solve(warm_start=...): warm-start rematching is not ported to "
            "torch yet; it comes with the serving tier (ROADMAP.md, Queue 1, "
            "item 9)")
    problem, report = _apply_preflight(problem, options)
    backend = _single.resolve_backend(options.backend, problem.device)
    kernel = backend in KERNEL_BACKENDS
    before = sum(launch_counts().values())
    engine = _batch._awpm_batched if problem.is_batched else _single._awpm
    state, iters = engine(
        problem.row, problem.col, problem.val, problem.n,
        max_iter=options.max_iter, min_gain=options.min_gain,
        backend=backend, window_steps=options.window_steps,
        degrade_infeasible=True)
    result = _result(state, iters, problem.n, batched=problem.is_batched)
    execution = ExecutionInfo(
        backend=backend,
        source="explicit" if options.backend != "auto" else "default",
        device=str(problem.device),
        ran_kernel=(sum(launch_counts().values()) > before) if kernel
        else None)
    result = dataclasses.replace(result, execution=execution)
    return _finish(problem, result, options, report)
