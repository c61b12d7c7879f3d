"""Guarded AWPM execution: deadlines, bounded retry, backend degradation,
and post-solve verification over ``repro_torch.core.api``.

A serving tier cannot call ``solve()`` naked: a kernel can fail to build
or launch on a new toolchain, a rank can drop out mid-exchange, a
transient runtime error can kill an otherwise healthy request, and a
silently wrong matching poisons the downstream factorization it exists
to stabilize. ``resilient_solve`` wraps the facade with the standard
serving guards:

  - **wall-clock deadline**: the request fails fast with
    ``DeadlineExceededError`` instead of hanging a caller;
  - **bounded retry with exponential backoff** for transient failures
    (``TransientFault``, CUDA and other runtime errors) on the same rung;
  - **backend degradation chain**: the requested engine first, then each
    strictly-more-conservative rung: a grid engine falls back to the local
    engines, ``cuda_persistent -> cuda -> torch -> reference``. The chain
    starts where ``core.single.resolve_backend`` puts "auto" on the
    problem's device: the persistent kernel on the card, the plain torch
    sweep on the CPU (so there the chain is torch -> reference). The rung
    that finally served the request is recorded, never hidden;
  - **rank-loss recovery**: with a ``runtime.elastic.FleetState``, a dead
    rank folds the grid down to ``elastic.surviving_grid`` before the grid
    rung runs (and to the local chain when no full row survived, or on a
    rank outside the surviving rectangle);
  - **post-solve verification**: structural invariants (mate
    bijectivity, matched edges exist in the instance, recomputed weight,
    perfect-flag consistency) on the host, and optionally a convergence
    audit (one reference winner-search pass on the result's device: a
    converged result must admit no augmenting 4-cycle) and a
    ``core.dual`` optimality certificate.

Every attempt, fallback, verification outcome, and the serving rung land
on the returned ``ResilienceReport``, with the seconds the guard spent
beside the solve (``ResilienceReport.split``). Errors that reflect the
*request* rather than the *execution* (bad types/options,
``PreflightError``, ``InfeasibleProblemError``) propagate immediately:
no amount of retrying fixes an infeasible instance. So does a kernel
library that does not build or load (``kernels.backend.KernelBuildError``):
every rung on the card loads the same library, and serving the plain
version in its place would hide the fault.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import api as _api
from repro_torch.core import dual as _dual
from repro_torch.core import single as _single
from repro_torch.core.dist import ExchangeIntegrityError
from repro_torch.core.preflight import PreflightError
from repro_torch.kernels.backend import KernelBuildError
from repro_torch.runtime import elastic

__all__ = [
    "Attempt",
    "DeadlineExceededError",
    "ResilienceReport",
    "ResilientMatcher",
    "ResilientOptions",
    "ResilientResult",
    "TransientFault",
    "VerificationError",
    "resilient_solve",
    "verify_result",
]


class TransientFault(RuntimeError):
    """A failure worth retrying on the same rung (injected by the chaos
    harness; real analogues: preempted device, flaky interconnect)."""


class DeadlineExceededError(RuntimeError):
    """The wall-clock deadline expired before any rung produced a verified
    result. Carries the partial ``report``."""

    def __init__(self, message: str, report: "ResilienceReport"):
        self.report = report
        super().__init__(message)


class VerificationError(RuntimeError):
    """Every rung either failed or produced a result that flunked
    post-solve verification. Carries the full ``report``; the verifier
    failures per rung are in its attempts."""

    def __init__(self, message: str, report: "ResilienceReport"):
        self.report = report
        super().__init__(message)


@dataclasses.dataclass(frozen=True)
class ResilientOptions:
    """Guard knobs, orthogonal to ``SolveOptions`` (which keeps owning the
    algorithm).

    deadline_s        wall-clock budget across ALL rungs/retries (None =
                      unbounded).
    max_retries       same-rung retries for transient failures.
    backoff_s         first retry delay; grows by ``backoff_factor``.
    verify            run the structural post-solve verifier on every
                      candidate result (a failure moves to the next rung).
    verify_convergence  additionally audit convergence with one reference
                      winner-search pass (catches a prematurely-converged
                      loop, e.g. a flipped convergence mask).
    certify           attach a ``core.dual`` certificate to perfect
                      results (skipped silently for imperfect ones).
    """

    deadline_s: float | None = None
    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    verify: bool = True
    verify_convergence: bool = False
    certify: bool = False

    def __post_init__(self):
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive or None, got {self.deadline_s!r}")
        if not isinstance(self.max_retries, int) or self.max_retries < 0:
            raise ValueError(
                f"max_retries must be a non-negative int, got "
                f"{self.max_retries!r}")


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One execution attempt: which rung, what happened."""

    rung: str  # e.g. "grid 2x4 (fused)", "local cuda_persistent"
    outcome: str  # "ok" | "transient" | "integrity" | "verify_failed"
    detail: str = ""
    wall_s: float = 0.0
    retry: int = 0  # 0 = first try on this rung


@dataclasses.dataclass(frozen=True)
class ResilienceReport:
    """Everything that happened while serving one request.

    ``split`` holds the seconds the guard spent around the solves, summed
    over the attempts: ``verify_s`` (the structural checks on the host,
    their copies included), ``audit_s`` (the convergence audit),
    ``certify_s`` (the certificate), ``host_copy_s`` and ``host_bytes``
    (the copies of the problem and the result to the host)."""

    attempts: tuple[Attempt, ...]
    backend_used: str | None = None  # rung label that served the request
    degraded: bool = False  # served by a rung below the requested one
    verification: tuple[str, ...] = ()  # failures of the SERVED result
    certificate: Any = None  # core.dual certificate(s) when requested
    split: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        served = self.backend_used or "unserved"
        flag = " (degraded)" if self.degraded else ""
        return (f"served by {served}{flag} after {len(self.attempts)} "
                f"attempt(s)")


@dataclasses.dataclass(frozen=True)
class ResilientResult:
    """A ``MatchResult`` plus the serving story."""

    result: _api.MatchResult
    report: ResilienceReport


# --------------------------------------------------------------------------
# post-solve verification
# --------------------------------------------------------------------------


def _verify_instance(row, col, val, n, mate_row, mate_col, weight, perfect,
                     iters, max_iter, min_gain, check_convergence, label,
                     audit=None):
    """Invariant checks for one instance (host numpy). ``audit()``, when
    the convergence audit is due, returns True if the result still admits
    an augmenting 4-cycle. Returns the failures."""
    fails = []
    mr = np.asarray(mate_row)
    mc = np.asarray(mate_col)
    if mr.shape != (n + 1,) or mc.shape != (n + 1,):
        return [f"{label}mate arrays have wrong shape {mr.shape}/{mc.shape}"]
    if mr[n] != n or mc[n] != n:
        fails.append(f"{label}sentinel slot corrupted: mate_row[n]={mr[n]}, "
                     f"mate_col[n]={mc[n]}")
    if ((mr < 0) | (mr > n)).any() or ((mc < 0) | (mc > n)).any():
        fails.append(f"{label}mate entries outside [0, n]")
        return fails
    # partial bijection: matched columns map to distinct rows and the two
    # mate arrays are mutual inverses on the matched set
    cols = np.flatnonzero(mr[:n] < n)
    rows = mr[cols]
    if np.unique(rows).size != rows.size:
        fails.append(f"{label}mate_row maps two columns to one row")
    elif not (mc[rows] == cols).all():
        fails.append(f"{label}mate_row/mate_col are not mutual inverses")
    rows2 = np.flatnonzero(mc[:n] < n)
    if rows2.size != cols.size:
        fails.append(f"{label}matched-row count {rows2.size} != "
                     f"matched-column count {cols.size}")
    # matched edges must exist in the instance; recompute the weight
    real = row < n
    key = row[real].astype(np.int64) * (n + 1) + col[real]
    order = np.argsort(key, kind="stable")
    skey = key[order]
    sval = val[real][order]
    qkey = rows.astype(np.int64) * (n + 1) + cols
    pos = np.searchsorted(skey, qkey)
    found = (pos < skey.size) & (skey[np.clip(pos, 0, skey.size - 1)] == qkey)
    if not found.all():
        miss = np.flatnonzero(~found)[0]
        fails.append(f"{label}matched edge ({int(rows[miss])}, "
                     f"{int(cols[miss])}) is not in the edge list")
    else:
        w = float(sval[pos].sum()) if qkey.size else 0.0
        if not np.isclose(w, float(weight), rtol=1e-4, atol=1e-4):
            fails.append(f"{label}recomputed weight {w:.6g} != reported "
                         f"{float(weight):.6g}")
    if bool(perfect) != (cols.size == n):
        fails.append(f"{label}perfect flag {bool(perfect)} inconsistent "
                     f"with {cols.size}/{n} matched columns")
    if check_convergence and bool(perfect) and int(iters) < int(max_iter) \
            and not fails and audit():
        fails.append(
            f"{label}result reported converged after {int(iters)} "
            f"round(s) but still admits an augmenting 4-cycle "
            f"(convergence mask was wrong)")
    return fails


def _host(x, split) -> np.ndarray:
    """A host numpy copy of a tensor on a device (its seconds and bytes
    added to ``split``), or a view of a tensor on the CPU or an array."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.device.type == "cpu":
        return x.detach().numpy()
    t0 = time.perf_counter()
    out = x.detach().cpu().numpy()
    split["host_copy_s"] = split.get("host_copy_s", 0.0) \
        + time.perf_counter() - t0
    split["host_bytes"] = split.get("host_bytes", 0) + out.nbytes
    return out


def _audit(row, col, val, n, mate_row, mate_col, min_gain, device) -> bool:
    """One reference winner-search pass over the state built from the
    mates, on ``device``: True if some column still has an augmenting
    4-cycle of gain above ``min_gain``."""
    def dev(x):
        return torch.as_tensor(x).to(device)

    row, col, val = dev(row), dev(col), dev(val)
    state = _single.state_from_mates(row, col, val, n, dev(mate_row),
                                     dev(mate_col))
    mg = _single._min_gain_tensor(min_gain, device)
    cgain, _, _, _ = _single.awac_cwinners(row, col, val, n, state, mg)
    return bool((cgain > mg).any())


def verify_result(problem: _api.MatchingProblem, result: _api.MatchResult,
                  options: _api.SolveOptions | None = None,
                  check_convergence: bool = False,
                  split: dict | None = None) -> tuple[str, ...]:
    """Re-check the permutation invariant and the reported weight of
    ``result`` against ``problem`` from scratch (host-side, independent of
    every engine; the problem and the result are copied to the host
    once). The convergence audit runs on the result's device. Returns a
    tuple of human-readable failures; empty means verified. ``split``,
    a dict, receives the seconds and bytes of the host copies, and the
    audit's seconds."""
    options = options or _api.SolveOptions()
    split = {} if split is None else split
    n = int(problem.n)
    device = result.mate_row.device \
        if isinstance(result.mate_row, torch.Tensor) else problem.device
    row, col, val = (_host(x, split)
                     for x in (problem.row, problem.col, problem.val))
    mr, mc, weight, perfect, iters = (
        _host(x, split) for x in (result.mate_row, result.mate_col,
                                  result.weight, result.perfect,
                                  result.awac_iters))

    def audit_of(sl):
        def audit():
            t0 = time.perf_counter()
            bad = _audit(problem.row[sl], problem.col[sl], problem.val[sl],
                         n, mr[sl], mc[sl], options.min_gain, device)
            split["audit_s"] = split.get("audit_s", 0.0) \
                + time.perf_counter() - t0
            return bad
        return audit

    if problem.is_batched:
        fails = []
        for bi in range(problem.batch_size):
            fails += _verify_instance(
                row[bi], col[bi], val[bi], n, mr[bi], mc[bi], weight[bi],
                perfect[bi], iters[bi], options.max_iter, options.min_gain,
                check_convergence, f"[instance {bi}] ", audit_of(bi))
        return tuple(fails)
    return tuple(_verify_instance(
        row, col, val, n, mr, mc, weight, perfect, iters, options.max_iter,
        options.min_gain, check_convergence, "", audit_of(slice(None))))


# --------------------------------------------------------------------------
# degradation chain
# --------------------------------------------------------------------------


#: most-aggressive to most-conservative: the persistent whole-loop kernel
#: degrades to the per-round sweep kernel, then the plain torch sweep,
#: then the reference path (a global lex search per round)
_LOCAL_CHAIN = ("cuda_persistent", "cuda", "torch", "reference")


def _local_options(options: _api.SolveOptions,
                   backend: str) -> _api.SolveOptions:
    """Strip the distributed-only knobs so a grid request can degrade to a
    local rung."""
    return dataclasses.replace(
        options, grid=None, cap=None, a2a_caps=None, packed=False,
        exchange_check=False, backend=backend)


def _build_rungs(options: _api.SolveOptions, device, fleet=None):
    """The degradation chain as (label, SolveOptions) pairs: the requested
    engine first, then every strictly-more-conservative rung. ``device``
    is where the problems lie: "auto" starts the local chain where
    ``single.resolve_backend`` puts it there."""
    rungs = []
    if options.grid is not None:
        grid = options.grid
        device = grid.device
        if fleet is not None and not fleet.alive.all():
            try:
                sub = elastic.surviving_grid(fleet, device=grid.device)
            except RuntimeError:
                sub = None  # no full row survived: straight to the local chain
            if sub is not None:  # None: this rank is outside the rectangle
                rungs.append((
                    f"grid {sub.pr}x{sub.pc} ({options._dist_backend()}, "
                    f"shrunk)", dataclasses.replace(options, grid=sub)))
        else:
            rungs.append((
                f"grid {grid.pr}x{grid.pc} ({options._dist_backend()})",
                options))
    start = options.backend
    if start not in _LOCAL_CHAIN:  # "auto", or the grid-only "fused"
        start = _single.resolve_backend("auto", device)
    for b in _LOCAL_CHAIN[_LOCAL_CHAIN.index(start):]:
        rungs.append((f"local {b}", _local_options(options, b)))
    return rungs


def _classify(exc: BaseException) -> str:
    """fatal: the request is wrong, or the kernels do not build (every
    rung on the card loads the same library), propagate. integrity: this
    rung's result can't be trusted, next rung, no retry. transient: same
    rung is worth retrying."""
    if isinstance(exc, (PreflightError, KernelBuildError)):
        return "fatal"  # a kernel that does not build never will
    if isinstance(exc, (TypeError, ValueError)):
        return "fatal"
    if isinstance(exc, ExchangeIntegrityError):
        return "integrity"
    return "transient"  # TransientFault, CUDA errors, other RuntimeErrors


# --------------------------------------------------------------------------
# the guarded loop
# --------------------------------------------------------------------------


def _sync(result) -> None:
    """Wait for the device work behind ``result`` (a rung's wall time ends
    there)."""
    if isinstance(result.mate_row, torch.Tensor) \
            and result.mate_row.device.type == "cuda":
        torch.cuda.synchronize(result.mate_row.device)


def _serve(problem, rungs, requested_label, options, resilience, run_rung):
    start_t = time.monotonic()
    attempts: list[Attempt] = []
    split = {"verify_s": 0.0}

    def remaining():
        if resilience.deadline_s is None:
            return None
        return resilience.deadline_s - (time.monotonic() - start_t)

    def fail(exc_cls, msg):
        report = ResilienceReport(attempts=tuple(attempts), split=split)
        raise exc_cls(msg + f" [{report.summary()}]", report)

    for label, opts in rungs:
        retry = 0
        while True:
            left = remaining()
            if left is not None and left <= 0:
                fail(DeadlineExceededError,
                     f"deadline {resilience.deadline_s}s expired before any "
                     f"rung produced a verified result")
            t0 = time.monotonic()
            try:
                result = run_rung(label, opts)
                _sync(result)
            except Exception as e:
                kind = _classify(e)
                if kind == "fatal":
                    raise
                attempts.append(Attempt(
                    rung=label,
                    outcome="integrity" if kind == "integrity" else
                    "transient", detail=f"{type(e).__name__}: {e}",
                    wall_s=time.monotonic() - t0, retry=retry))
                if kind == "integrity" or retry >= resilience.max_retries:
                    break  # next rung
                delay = resilience.backoff_s * \
                    resilience.backoff_factor ** retry
                if (left := remaining()) is not None:
                    delay = min(delay, max(left, 0.0))
                time.sleep(delay)
                retry += 1
                continue
            wall = time.monotonic() - t0
            fails = ()
            if resilience.verify:
                t1 = time.perf_counter()
                audit_before = split.get("audit_s", 0.0)
                fails = verify_result(
                    problem, result, opts,
                    check_convergence=resilience.verify_convergence,
                    split=split)
                split["verify_s"] += time.perf_counter() - t1 \
                    - (split.get("audit_s", 0.0) - audit_before)
            if fails:
                attempts.append(Attempt(
                    rung=label, outcome="verify_failed",
                    detail="; ".join(fails), wall_s=wall, retry=retry))
                break  # a wrong result is not retryable on the same rung
            attempts.append(Attempt(rung=label, outcome="ok", wall_s=wall,
                                    retry=retry))
            cert = None
            if resilience.certify and bool(
                    torch.as_tensor(result.perfect).all()):
                t1 = time.perf_counter()
                cert = _dual.certify(problem, result)
                split["certify_s"] = time.perf_counter() - t1
            report = ResilienceReport(
                attempts=tuple(attempts), backend_used=label,
                degraded=label != requested_label, verification=fails,
                certificate=cert, split=split)
            return ResilientResult(result=result, report=report)
    fail(VerificationError,
         "every rung failed or produced a result that flunked verification")


def resilient_solve(problem: _api.MatchingProblem,
                    options: _api.SolveOptions | None = None,
                    resilience: ResilientOptions | None = None,
                    fleet=None, warm_start=None) -> ResilientResult:
    """``core.api.solve`` behind the full guard stack (module docstring).
    ``fleet`` is an optional ``runtime.elastic.FleetState`` consulted
    before the grid rung; with a grid, every rank calls this with the
    same problem and fleet. ``warm_start`` threads straight through to
    ``solve`` on every rung; a seed the facade rejects as stale raises
    immediately (fatal: the *request* is wrong, no rung can fix it; the
    serving tier's ``serving.warm.solve_with_seed`` owns the cold
    fallback). Returns a :class:`ResilientResult`; raises
    ``DeadlineExceededError`` / ``VerificationError`` (each carrying the
    report) when no rung can serve, and propagates request errors
    (``PreflightError`` etc.) untouched."""
    options = _api.SolveOptions() if options is None else options
    resilience = ResilientOptions() if resilience is None else resilience
    if not isinstance(problem, _api.MatchingProblem):
        raise TypeError(
            f"resilient_solve() takes a MatchingProblem, got "
            f"{type(problem).__name__}")
    rungs = _build_rungs(options, problem.device, fleet=fleet)
    return _serve(problem, rungs, rungs[0][0], options, resilience,
                  lambda label, opts: _api.solve(
                      problem, opts, warm_start=warm_start))


class ResilientMatcher:
    """The plan-once/run-many analogue of :func:`resilient_solve`: one
    planned ``Matcher`` per rung (built lazily on first use, cached), the
    same guarded serving loop per call. ``device`` is where the problems
    will lie (None: the card; a prototype problem, or a grid, gives its
    own); it decides where "auto" starts the local chain."""

    def __init__(self, problem_spec, options: _api.SolveOptions | None = None,
                 resilience: ResilientOptions | None = None, fleet=None,
                 device=None):
        self.options = _api.SolveOptions() if options is None else options
        self.resilience = ResilientOptions() if resilience is None \
            else resilience
        self.fleet = fleet
        self._spec = problem_spec
        if isinstance(problem_spec, _api.MatchingProblem):
            device = problem_spec.device
        self.device = _api.resolve_device(device) if self.options.grid is None \
            else self.options.grid.device
        self._rungs = _build_rungs(self.options, self.device, fleet=fleet)
        self._matchers: dict[str, _api.Matcher] = {}

    def _matcher(self, label, opts) -> _api.Matcher:
        m = self._matchers.get(label)
        if m is None:
            m = _api.plan(self._spec, opts)
            self._matchers[label] = m
        return m

    def __call__(self, problem: _api.MatchingProblem,
                 warm_start=None) -> ResilientResult:
        if isinstance(problem, _api.MatchingProblem) \
                and problem.device.type != self.device.type:
            raise ValueError(
                f"the problem lies on {problem.device}, the matcher's "
                f"chain was built for {self.device}")
        return _serve(
            problem, self._rungs, self._rungs[0][0], self.options,
            self.resilience,
            lambda label, opts: self._matcher(label, opts)(
                problem, warm_start=warm_start))

    def __repr__(self):
        return (f"ResilientMatcher(rungs={[r for r, _ in self._rungs]}, "
                f"resilience={self.resilience})")
