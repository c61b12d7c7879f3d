"""End-to-end static-pivoting linear solver.

``solve_linear_system(A, b, pivoting=...)`` is the repo's answer to "so
does the matching actually help?": it composes every layer built so far —

  preflight (core.preflight, structural audit)
    -> AWPM matching (core.api.solve, on the card unless the caller asks
       for the CPU) or exact reference or nothing
    -> permutation + MC64 scalings from dual potentials (solver.pivoting)
    -> static-pivot sparse LU with GESP perturbation (solver.lu, host)
    -> f32 triangular solves on the device + f64 iterative refinement on
       the host (solver.refine)

and returns ONE typed :class:`SolveReport` carrying the full audit trail:
what preflight saw, how dominant the matched diagonal was, how much fill
and pivot growth the factorization paid, the whole refinement residual
trajectory, and the true float64 residual of the returned x against the
ORIGINAL (unscaled, unpermuted) system. The three ``pivoting`` arms (with
``lu_mode="threshold"`` as a fourth) are the experiment of
``repro_torch.solver.experiments``:

- ``"awpm"`` — the paper's pipeline (approximate matching, static pivots);
- ``"reference"`` — exact MC64-style matching (scipy Hungarian oracle),
  same scaling recovery, isolating matching quality;
- ``"none"`` — no permutation, no scaling: the contrast arm that is
  ALLOWED to fail, and whose failure on ill-conditioned instances is the
  reproduced result.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.solver import pivoting as _pivoting
from repro_torch.solver.lu import CsrMatrix, LUStats, sparse_lu
from repro_torch.solver.refine import RefineResult, refine

__all__ = ["PIVOTING_MODES", "SolveReport", "solve_linear_system"]

PIVOTING_MODES = ("awpm", "none", "reference")


@dataclasses.dataclass(frozen=True)
class SolveReport:
    """Everything one ``solve_linear_system`` call learned.

    ``x`` solves the ORIGINAL ``A x = b`` (scalings/permutations are
    internal); ``residual`` is its true float64 relative residual
    ``||b - A x||_2 / ||b||_2`` per RHS, recomputed from scratch — the
    number the acceptance gate reads, independent of anything the
    refinement loop believed. ``converged`` is ``residual <= tol``.
    ``split`` holds the seconds of the three stages: ``matching_s`` (the
    pivoting: matching, certificate and scalings), ``lu_s`` (the
    factorization) and ``refine_s`` (the refinement).
    """

    x: np.ndarray  # [n] or [B, n]
    pivoting: str
    preflight: object  # core.preflight.PreflightReport
    pivot: _pivoting.ScaledPivoting
    lu_stats: LUStats
    refinement: RefineResult
    residual: np.ndarray  # [B] float64 true relative residuals
    converged: np.ndarray  # [B] bool: residual <= tol
    tol: float
    scaled_diag_min: float  # min |diag| after permute+scale (1.0 ideal)
    matching_weight: float | None = None  # log2-metric weight (awpm/ref)
    matching_tight: bool | None = None  # dual certificate converged
    split: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return bool(np.asarray(self.converged).all())

    def summary(self) -> str:
        res = float(np.max(self.residual))
        s = self.lu_stats
        return (f"pivoting={self.pivoting} n={s.n} nnz={s.nnz_in} "
                f"fill={s.fill_ratio:.2f} growth={s.pivot_growth:.3g} "
                f"perturbed={s.perturbed_pivots} "
                f"diag_min={self.scaled_diag_min:.3g} "
                f"sweeps={int(np.max(self.refinement.iterations))} "
                f"residual={res:.3e} "
                f"{'CONVERGED' if self.ok else 'FAILED'}")


def _as_coo(a):
    """Accept a dense [n, n] array, a CsrMatrix, or a (row, col, val, n)
    COO tuple; return deduped, zero-dropped host triples."""
    from repro_torch.sparse.csr import dedupe_coo_sum

    if isinstance(a, CsrMatrix):
        row = np.repeat(np.arange(a.n, dtype=np.int64),
                        np.diff(a.indptr).astype(np.int64))
        col, val, n = np.asarray(a.indices, np.int64), a.data, a.n
    elif isinstance(a, tuple) and len(a) == 4:
        row, col, val, n = a
        row = np.asarray(row, np.int64)
        col = np.asarray(col, np.int64)
        val = np.asarray(val)
        n = int(n)
    else:
        dense = np.asarray(a)
        if dense.ndim != 2 or dense.shape[0] != dense.shape[1]:
            raise ValueError(
                f"A must be square 2-D (or CsrMatrix / (row, col, val, n) "
                f"COO), got shape {dense.shape}")
        row, col = np.nonzero(dense)
        val, n = dense[row, col], dense.shape[0]
    row, col, val = dedupe_coo_sum(row, col, val, n_cols=n)
    keep = val != 0
    dtype = np.complex128 if np.iscomplexobj(val) else np.float64
    return (np.asarray(row[keep], np.int64), np.asarray(col[keep], np.int64),
            np.asarray(val[keep], dtype), n)


def solve_linear_system(a, b, *, pivoting: str = "awpm",
                        lu_mode: str = "static", lu_threshold: float = 0.1,
                        tol: float = 1e-10, max_iter: int = 40,
                        options=None, check: bool = True,
                        device=None) -> SolveReport:
    """Solve ``A x = b`` with matching-based static pivoting.

    ``a``: dense square array, :class:`CsrMatrix`, or ``(row, col, val,
    n)`` COO (real or complex; duplicates summed, explicit zeros
    dropped). ``b``: ``[n]`` or batched ``[B, n]``. ``pivoting`` is one
    of :data:`PIVOTING_MODES`; ``lu_mode="threshold"`` swaps the
    factorization to classical threshold partial pivoting (comparison
    arm, any pivoting mode). ``check=False`` downgrades structural
    preflight failures from an exception to a report-carried finding —
    only ``pivoting="none"`` can proceed past one (a matching needs a
    perfect matching to exist). ``device`` (None: the card) runs the AWPM
    matching and the refinement's triangular sweeps; the preflight, the
    factorization and the float64 residuals are host numpy.

    Never raises on NUMERICAL failure: a diverged refinement comes back
    as ``report.ok == False`` with the trajectory attached. That is the
    contract ``repro_torch.solver.experiments`` depends on: the "none"
    arm failing is data, not a crash.
    """
    from repro_torch.core.api import MatchingProblem
    from repro_torch.core.preflight import PreflightError, preflight

    if pivoting not in PIVOTING_MODES:
        raise ValueError(
            f"pivoting must be one of {PIVOTING_MODES}, got {pivoting!r}")
    row, col, val, n = _as_coo(a)
    b = np.asarray(b)
    if b.shape[-1] != n:
        raise ValueError(f"b has width {b.shape[-1]}, matrix order is {n}")

    # preflight the MATCHING view (structure is shared with the linear
    # system: an empty row/col is singular either way)
    problem = MatchingProblem.from_coo(row, col, np.abs(val), n,
                                       device="cpu")
    report = preflight(problem)
    if not report.solvable and (check or pivoting != "none"):
        raise PreflightError(report)

    matching_weight = matching_tight = None
    t0 = time.perf_counter()
    if pivoting == "awpm":
        pivot, result = _pivoting.awpm_pivoting(row, col, val, n,
                                                options=options,
                                                device=device)
        if not bool(result.perfect.all()):
            raise PreflightError(report, (
                "AWPM did not reach a perfect matching — static pivoting "
                "needs one. Preflight was clean, so this is an engine "
                "limit; try pivoting='reference'."))
    elif pivoting == "reference":
        pivot, _ = _pivoting.reference_pivoting(row, col, val, n)
    else:
        pivot = _pivoting.identity_pivoting(n)
    if pivot.certificate is not None:
        matching_weight = float(pivot.certificate.weight)
        matching_tight = bool(pivot.certificate.tight)

    t1 = time.perf_counter()

    pr, pc, pv = pivot.scaled_coo(row, col, val)
    diag = pivot.scaled_diag(row, col, val)
    scaled = CsrMatrix.from_coo(pr, pc, pv, n)
    factor = sparse_lu(scaled, mode=lu_mode, threshold=lu_threshold)
    t2 = time.perf_counter()

    # refine in the scaled frame (that is where the factors live), then
    # map back: A x = b  <=>  (P Dr A Dc) y = P Dr b,  x = Dc y
    sb = pivot.scale_rhs(b)
    refinement = refine(scaled, factor, sb,
                        tol=max(tol * 1e-2, 1e-14), max_iter=max_iter,
                        device=device)
    t3 = time.perf_counter()
    y = refinement.x
    x = pivot.unscale_solution(y)

    # the verdict: true residual against the ORIGINAL system, f64
    acc = np.complex128 if (np.iscomplexobj(val) or np.iscomplexobj(b)) \
        else np.float64
    xb = (x[None, :] if x.ndim == 1 else x).astype(acc)
    bb = (b[None, :] if b.ndim == 1 else b).astype(acc)
    ax_t = np.zeros((n, bb.shape[0]), acc)  # [n, B]: A @ x per lane
    np.add.at(ax_t, row, val[:, None] * xb[:, col].T)
    rr = bb - ax_t.T
    bnorm = np.linalg.norm(bb, axis=-1)
    bnorm = np.where(bnorm == 0.0, 1.0, bnorm)
    residual = np.linalg.norm(rr, axis=-1) / bnorm
    converged = np.isfinite(residual) & (residual <= tol)

    return SolveReport(
        x=x, pivoting=pivoting, preflight=report, pivot=pivot,
        lu_stats=factor.stats, refinement=refinement,
        residual=residual, converged=converged, tol=float(tol),
        scaled_diag_min=float(diag.min()) if n else 1.0,
        matching_weight=matching_weight, matching_tight=matching_tight,
        split=dict(matching_s=t1 - t0, lu_s=t2 - t1, refine_s=t3 - t2))
