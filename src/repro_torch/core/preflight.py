"""Preflight: structural validation of a ``MatchingProblem`` before solve.

The paper's target regime (SuperLU_DIST pre-pivoting at 256 nodes) feeds
AWPM matrices straight off disk or out of a factorization pipeline —
exactly where degenerate inputs appear: ``nan``/``inf`` weights from a
broken transform, duplicate coordinate entries from unassembled triplet
files, empty rows/columns (structurally singular blocks), and instances
with no perfect matching at all. The engines assume none of that: a NaN
weight silently poisons every gain comparison, and an infeasible instance
can never become perfect no matter how long AWAC runs (4-cycle
augmentation preserves cardinality), so every AWAC round spent on one is
pure waste.

This module is the cheap host-side pass that turns those failure modes
into typed, located diagnoses, wired into ``solve()`` through
``SolveOptions(on_invalid=...)``:

  raise      (default) any fatal data issue or an infeasible instance
             raises ``PreflightError`` / ``InfeasibleProblemError``.
  sanitize   fatal data issues are repaired (non-finite edges dropped,
             duplicate coordinates merged keep-max); infeasibility still
             raises — sanitization fixes data, not structure.
  degrade    repair like ``sanitize``, and return the maximal (imperfect)
             matching with ``perfect=False`` plus the diagnosis attached
             as ``MatchResult.diagnosis`` instead of raising.

Under every policy the solve pipeline short-circuits infeasible instances
after the MCM phase (the cardinality ceiling is known there), so a
deficiency-1 instance costs O(greedy + MCM) work, never ``max_iter`` AWAC
rounds. All checks run on host copies of the edge arrays.

Check catalogue (severities):

  nonfinite_weight   fatal       nan/inf edge weights
  duplicate_edge     fatal       repeated (row, col) coordinates
  negative_weight    warning     legitimate in e.g. the raw log2_scaled
                                 metric — reported, never repaired/raised
  empty_row          structural  a row with no edges (no perfect matching)
  empty_col          structural  a column with no edges
  deficient          structural  max cardinality < n (MCM screen — found
                                 by ``preflight(feasibility=True)`` or by
                                 the solve pipeline's own MCM phase)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch import obs

__all__ = [
    "InfeasibleProblemError",
    "PreflightError",
    "PreflightIssue",
    "PreflightReport",
    "preflight",
    "sanitize",
]

#: issue kind -> severity ("fatal" data corruption, "structural"
#: infeasibility, "warning" reported-but-legal)
SEVERITIES = {
    "nonfinite_weight": "fatal",
    "duplicate_edge": "fatal",
    "negative_weight": "warning",
    "empty_row": "structural",
    "empty_col": "structural",
    "deficient": "structural",
}


@dataclasses.dataclass(frozen=True)
class PreflightIssue:
    """One located finding. ``instance`` is the batch index (None for a
    single-instance problem), ``where`` a small sample of offending
    indices (edge positions for data issues, row/col ids for structural
    ones) — enough to locate the problem without hauling O(m) data."""

    kind: str
    count: int
    detail: str
    instance: int | None = None
    where: tuple[int, ...] = ()

    @property
    def severity(self) -> str:
        return SEVERITIES[self.kind]

    def __str__(self):
        at = "" if self.instance is None else f" [instance {self.instance}]"
        return f"{self.kind}{at}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class PreflightReport:
    """The typed diagnosis: every issue found, queryable by severity."""

    issues: tuple[PreflightIssue, ...]
    checked_feasibility: bool = False

    @property
    def ok(self) -> bool:
        """No issues at all (warnings included)."""
        return not self.issues

    @property
    def fatal(self) -> tuple[PreflightIssue, ...]:
        return tuple(i for i in self.issues if i.severity == "fatal")

    @property
    def structural(self) -> tuple[PreflightIssue, ...]:
        return tuple(i for i in self.issues if i.severity == "structural")

    @property
    def warnings(self) -> tuple[PreflightIssue, ...]:
        return tuple(i for i in self.issues if i.severity == "warning")

    @property
    def solvable(self) -> bool:
        """No fatal data corruption and no structural infeasibility."""
        return not self.fatal and not self.structural

    def summary(self) -> str:
        if not self.issues:
            return "preflight: clean"
        return "; ".join(str(i) for i in self.issues)

    def extend(self, *issues: PreflightIssue) -> "PreflightReport":
        return PreflightReport(self.issues + tuple(issues),
                               self.checked_feasibility)


class PreflightError(ValueError):
    """A fatal or structural preflight finding under ``on_invalid="raise"``.
    Carries the full typed ``report``."""

    def __init__(self, report: PreflightReport, message: str | None = None):
        self.report = report
        super().__init__(message or report.summary())


class InfeasibleProblemError(PreflightError):
    """The instance admits no perfect matching (empty row/column or a
    Hall-violating deficiency found by the MCM screen)."""


def _host(problem):
    """numpy copies of the problem's edge arrays: three reads of the
    device."""
    with obs.span("preflight.copy"):
        out = []
        for x in (problem.row, problem.col, problem.val):
            with obs.d2h("preflight"):
                out.append(x.cpu().numpy())
        return tuple(out)


def _sample(idx: np.ndarray, k: int = 4) -> tuple[int, ...]:
    return tuple(int(x) for x in idx[:k])


def _scan_instance(row, col, val, n: int, inst: int | None):
    """All cheap checks for one instance's padded COO triple (host numpy)."""
    issues = []
    real = (row < n) & (col < n)
    r, c, v = row[real], col[real], val[real]
    pos = np.flatnonzero(real)

    bad = ~np.isfinite(v)
    if bad.any():
        where = pos[bad]
        issues.append(PreflightIssue(
            "nonfinite_weight", int(bad.sum()),
            f"{int(bad.sum())} non-finite edge weight(s), e.g. edge "
            f"#{int(where[0])} ({int(r[bad][0])}, {int(c[bad][0])}) = "
            f"{v[bad][0]!r}", inst, _sample(where)))

    neg = np.isfinite(v) & (v < 0)
    if neg.any():
        issues.append(PreflightIssue(
            "negative_weight", int(neg.sum()),
            f"{int(neg.sum())} negative edge weight(s) (min "
            f"{float(v[neg].min()):g}) — legal, but consider a "
            f"decision-invariant non-negative lift "
            f"(data.weight_transforms)", inst, _sample(pos[neg])))

    key = r.astype(np.int64) * (n + 1) + c
    skey = np.sort(key)
    dup = skey[1:] == skey[:-1]
    if dup.any():
        k0 = int(skey[1:][dup][0])
        issues.append(PreflightIssue(
            "duplicate_edge", int(dup.sum()),
            f"{int(dup.sum())} duplicate (row, col) coordinate(s), e.g. "
            f"({k0 // (n + 1)}, {k0 % (n + 1)}) — merge duplicates "
            f"(from_coo keeps raw triples as given)", inst,
            _sample(np.unique(skey[1:][dup]))))

    row_deg = np.bincount(r, minlength=n)
    col_deg = np.bincount(c, minlength=n)
    er = np.flatnonzero(row_deg == 0)
    ec = np.flatnonzero(col_deg == 0)
    if er.size:
        issues.append(PreflightIssue(
            "empty_row", int(er.size),
            f"{er.size} row(s) with no edges (e.g. row {int(er[0])}): no "
            f"perfect matching exists", inst, _sample(er)))
    if ec.size:
        issues.append(PreflightIssue(
            "empty_col", int(ec.size),
            f"{ec.size} column(s) with no edges (e.g. column "
            f"{int(ec[0])}): no perfect matching exists", inst,
            _sample(ec)))
    return issues


def preflight(problem, *, feasibility: bool = False) -> PreflightReport:
    """Run the structural pass over ``problem`` (host numpy, O(m log m)).

    ``feasibility=True`` additionally runs the greedy + MCM screen (the
    existing pipeline phases — O(MCM) work, no AWAC) and reports any
    Hall-style deficiency the cheap empty-row/column check cannot see.
    """
    row, col, val = _host(problem)
    n = int(problem.n)
    issues = []
    with obs.span("preflight.scan"):
        if row.ndim == 1:
            issues += _scan_instance(row, col, val, n, None)
        else:
            for b in range(row.shape[0]):
                issues += _scan_instance(row[b], col[b], val[b], n, b)
    if feasibility:
        issues += _mcm_screen(problem)
    return PreflightReport(tuple(issues), checked_feasibility=feasibility)


def _mcm_screen(problem) -> list[PreflightIssue]:
    """Hall-style deficiency screen via the pipeline's own greedy + MCM
    phases (maximum cardinality is exact, so deficiency = n - |MCM|)."""
    from repro_torch.core import batch as _batch
    from repro_torch.core import single as _single

    n = int(problem.n)
    row, col, val = problem.row, problem.col, problem.val
    issues = []
    if row.dim() == 2:
        mr, mc = _batch.greedy_maximal_batched(row, col, val, n)
        mr, _ = _batch.mcm_batched(row, col, val, n, mr, mc)
        card = (mr[:, :n] < n).sum(dim=1).tolist()
        for b, k in enumerate(card):
            if int(k) < n:
                issues.append(_deficiency_issue(n, int(k), b))
    else:
        st = _single.greedy_maximal(row, col, val, n)
        st = _single.mcm(row, col, val, n, st.mate_row, st.mate_col)
        k = int((st.mate_row[:n] < n).sum())
        if k < n:
            issues.append(_deficiency_issue(n, k, None))
    return issues


def _deficiency_issue(n: int, cardinality: int,
                      inst: int | None) -> PreflightIssue:
    return PreflightIssue(
        "deficient", n - cardinality,
        f"maximum cardinality {cardinality} < n = {n} "
        f"(deficiency {n - cardinality}): no perfect matching exists",
        inst)


def deficiency_from_mates(mate_row, n: int, report: PreflightReport | None,
                          batched: bool) -> PreflightReport:
    """Fold the deficiency observed on a solved (maximal) matching into a
    report — how the solve pipeline attaches its free MCM screen result."""
    report = report or PreflightReport(())
    if hasattr(mate_row, "cpu"):
        with obs.d2h("deficiency"):
            mr = mate_row.cpu().numpy()
    else:
        mr = np.asarray(mate_row)
    issues = []
    if batched:
        card = (mr[:, :n] < n).sum(axis=1)
        issues = [_deficiency_issue(n, int(k), b)
                  for b, k in enumerate(card) if int(k) < n]
    else:
        k = int((mr[:n] < n).sum())
        if k < n:
            issues = [_deficiency_issue(n, k, None)]
    return report.extend(*issues)


def _sanitize_triple(row, col, val, n: int):
    """Drop non-finite edges, merge duplicate coordinates keep-max.
    Returns (row, col, val) raw (unpadded) real triples."""
    real = (row < n) & (col < n)
    r, c, v = row[real], col[real], val[real]
    keep = np.isfinite(v)
    r, c, v = r[keep], c[keep], v[keep]
    # keep-max merge: within duplicate (row, col) groups the heaviest entry
    # dominates any max-weight matching objective (an edge is picked at
    # most once). Summation semantics belong to assembly (data.mtx).
    order = np.lexsort((-v, c, r))
    r, c, v = r[order], c[order], v[order]
    key = r.astype(np.int64) * (n + 1) + c
    first = np.ones(key.shape, bool)
    first[1:] = key[1:] != key[:-1]
    return r[first], c[first], v[first]


def sanitize(problem) -> tuple[Any, PreflightReport]:
    """Repair fatal data issues (non-finite edges dropped, duplicates
    merged keep-max), preserving the problem's padded capacity and device.
    Structural issues are reported, not repaired. Returns (sanitized
    problem, report of what was found)."""
    from repro_torch.core import graph as _graph
    from repro_torch.core.api import MatchingProblem

    report = preflight(problem)
    if not report.fatal:
        return problem, report
    n, cap = int(problem.n), problem.cap
    device = problem.row.device
    row, col, val = _host(problem)
    if row.ndim == 1:
        r, c, v = _sanitize_triple(row, col, val, n)
        g = _graph.from_coo(r, c, v, n, capacity=cap)
        clean = MatchingProblem.from_graph(g, device=device)
    else:
        gs = []
        for b in range(row.shape[0]):
            r, c, v = _sanitize_triple(row[b], col[b], val[b], n)
            gs.append(_graph.from_coo(r, c, v, n, capacity=cap))
        clean = MatchingProblem.stack(gs, device=device)
    return clean, report
