"""repro_torch.core — heavy-weight perfect bipartite matching (AWPM =
greedy maximal -> MCM -> AWAC 4-cycles) on torch tensors.

Public surface: build a :class:`MatchingProblem`, tune
:class:`SolveOptions` (``grid=make_grid(pr, pc)`` for the 2D process
grid), call :func:`solve` (``warm_start=`` to seed it from an earlier
matching), or :func:`plan` for a plan-once/run-many :class:`Matcher`;
:func:`certify` bounds a result against the optimum, ``pivot`` turns
matchings into static-pivoting row permutations.
"""
from repro_torch.core import (
    api,
    batch,
    convert,
    dist,
    dual,
    graph,
    pivot,
    preflight,
    ref,
    single,
)
from repro_torch.core.api import (
    BACKENDS,
    ON_INVALID,
    ExecutionInfo,
    Matcher,
    MatchingProblem,
    MatchResult,
    ProblemSpec,
    SolveOptions,
    plan,
    solve,
)
from repro_torch.core.constants import MIN_GAIN
from repro_torch.core.dist import ExchangeIntegrityError, GridSpec, make_grid
from repro_torch.core.dual import DualCertificate, certify, dual_certificate
from repro_torch.core.graph import BipartiteGraph, from_coo, generate, matrix_suite
from repro_torch.core.preflight import (
    InfeasibleProblemError,
    PreflightError,
    PreflightReport,
)
from repro_torch.core.single import MatchState

__all__ = [
    "api",
    "batch",
    "convert",
    "dist",
    "dual",
    "graph",
    "pivot",
    "preflight",
    "ref",
    "single",
    "BACKENDS",
    "MIN_GAIN",
    "ON_INVALID",
    "BipartiteGraph",
    "DualCertificate",
    "ExchangeIntegrityError",
    "ExecutionInfo",
    "GridSpec",
    "InfeasibleProblemError",
    "MatchResult",
    "MatchState",
    "Matcher",
    "MatchingProblem",
    "PreflightError",
    "PreflightReport",
    "ProblemSpec",
    "SolveOptions",
    "certify",
    "dual_certificate",
    "from_coo",
    "generate",
    "make_grid",
    "matrix_suite",
    "plan",
    "solve",
]
