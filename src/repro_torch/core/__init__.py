"""repro_torch.core — heavy-weight perfect bipartite matching (AWPM =
greedy maximal -> MCM -> AWAC 4-cycles) on torch tensors.

Public surface: build a :class:`MatchingProblem`, tune
:class:`SolveOptions`, call :func:`solve`.
"""
from repro_torch.core import api, batch, convert, graph, preflight, ref, single
from repro_torch.core.api import (
    BACKENDS,
    ON_INVALID,
    ExecutionInfo,
    MatchingProblem,
    MatchResult,
    ProblemSpec,
    SolveOptions,
    solve,
)
from repro_torch.core.constants import MIN_GAIN
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
    "graph",
    "preflight",
    "ref",
    "single",
    "BACKENDS",
    "MIN_GAIN",
    "ON_INVALID",
    "BipartiteGraph",
    "ExecutionInfo",
    "InfeasibleProblemError",
    "MatchResult",
    "MatchState",
    "MatchingProblem",
    "PreflightError",
    "PreflightReport",
    "ProblemSpec",
    "SolveOptions",
    "from_coo",
    "generate",
    "matrix_suite",
    "solve",
]
