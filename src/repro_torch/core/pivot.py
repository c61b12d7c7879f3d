"""Static pivoting — the paper's motivating application (§6.6).

A perfect matching on the bipartite graph of a sparse matrix gives a row
permutation placing "heavy" entries on the diagonal, so a distributed LU
factorization can proceed without dynamic pivoting (SuperLU_DIST's usage of
MC64). Two objective metrics, as in the paper:

  - "sum":     maximize sum of matched |a_ij|            (MC64 option 4)
  - "product": maximize product of |a_ij| = sum of logs  (MC64 option 5,
               used in Table 6.3)

Includes the LAPACK-style equilibration of §6.6 and an (intentionally)
pivot-free LU solver to measure the solution error the permutation buys.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import MatchingProblem, SolveOptions, solve
from repro_torch.core.graph import BipartiteGraph, from_coo


def log_transformed(g: BipartiteGraph, floor: float = 1e-30) -> BipartiteGraph:
    """Edge weights |a_ij| -> log|a_ij| (product metric). Padding stays 0."""
    m = np.arange(g.capacity) < g.nnz
    val = g.val.copy()
    val[m] = np.log(np.maximum(np.abs(val[m]), floor)).astype(np.float32)
    return BipartiteGraph(n=g.n, nnz=g.nnz, row=g.row, col=g.col, val=val)


def equilibrate(a: np.ndarray):
    """Row/column scaling D_r A D_c with unit row/col max (LAPACK-style simple
    equilibration, one pass each). Returns (scaled, d_r, d_c)."""
    absa = np.abs(a)
    d_r = 1.0 / np.maximum(absa.max(axis=1), 1e-300)
    a1 = a * d_r[:, None]
    d_c = 1.0 / np.maximum(np.abs(a1).max(axis=0), 1e-300)
    return a1 * d_c[None, :], d_r, d_c


def row_permutation(mate_row: np.ndarray, n: int) -> np.ndarray:
    """perm such that (P_r A)[j, j] = A[mate_row[j], j] is the matched entry."""
    perm = np.asarray(mate_row[:n], dtype=np.int64)
    assert (perm < n).all(), "matching must be perfect for static pivoting"
    return perm


def lu_nopivot(a: np.ndarray):
    """Doolittle LU with NO pivoting — emulates the distributed solver's
    static-pivot factorization. Returns (L, U) or raises on zero pivot."""
    n = a.shape[0]
    lu = a.astype(np.float64).copy()
    for k in range(n - 1):
        piv = lu[k, k]
        if piv == 0.0:
            raise ZeroDivisionError(f"zero pivot at {k}")
        lu[k + 1 :, k] /= piv
        lu[k + 1 :, k + 1 :] -= np.outer(lu[k + 1 :, k], lu[k, k + 1 :])
    ell = np.tril(lu, -1) + np.eye(n)
    return ell, np.triu(lu)


def solve_nopivot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    from scipy.linalg import solve_triangular

    ell, u = lu_nopivot(a)
    y = solve_triangular(ell, b, lower=True, unit_diagonal=True)
    return solve_triangular(u, y)


def static_pivot_solve(a: np.ndarray, b: np.ndarray, mate_row: np.ndarray):
    """Full §6.6 pipeline: equilibrate -> permute rows by the matching ->
    LU without pivoting -> undo scalings. Returns x and the relative error
    helper expects x_true separately."""
    n = a.shape[0]
    a_s, d_r, d_c = equilibrate(a)
    perm = row_permutation(mate_row, n)
    a_p = a_s[perm, :]
    b_p = (b * d_r)[perm]
    y = solve_nopivot(a_p, b_p)
    return d_c * y


def relative_error(x: np.ndarray, x_true: np.ndarray) -> float:
    return float(np.max(np.abs(x - x_true)) / max(np.max(np.abs(x)), 1e-300))


# --------------------------------------------------------------------------
# Multi-matrix batched pivoting (one matching dispatch for a whole batch)
# --------------------------------------------------------------------------


def batched_pivot_permutations(mats, metric: str = "product",
                               backend: str = "auto", grid=None,
                               device=None):
    """AWPM row permutations for a batch of same-size matrices through ONE
    batched ``api.solve`` call — the pivot-serving path: SuperLU/PARDISO-
    style preprocessing pipelines hold many matrices, and the matching
    engine is the shared front-end. ``grid=None`` runs the local batched
    engine on ``device`` (None: the card); a ``core.dist.GridSpec`` runs
    the whole batch on that process grid, on its device — bit-identical
    permutations.

    metric: "product" (log-weights, MC64 option-5 analogue, Table 6.3) or
    "sum" (raw |a_ij|). Each matrix is equilibrated first, as in §6.6.
    Returns (perms [B, n] int64, awac_iters [B]), numpy."""
    if metric not in ("product", "sum"):
        raise ValueError(f"unknown pivot metric {metric!r}")
    n = mats[0].shape[0]
    gs = []
    for a in mats:
        if a.shape != (n, n):
            raise ValueError("all matrices in a batch must share n")
        a_s, _, _ = equilibrate(np.asarray(a))
        rr, cc = np.nonzero(a_s)
        g = from_coo(rr.astype(np.int32), cc.astype(np.int32),
                     np.abs(a_s[rr, cc]).astype(np.float32), n)
        gs.append(log_transformed(g) if metric == "product" else g)
    if grid is not None:
        device = grid.device
    res = solve(MatchingProblem.stack(gs, device=device),
                SolveOptions(backend=backend, grid=grid))
    mrs = res.mate_row[:, :n].cpu().numpy()
    perms = np.stack([row_permutation(mr, n) for mr in mrs])
    return perms, res.awac_iters.cpu().numpy()


def static_pivot_solve_batched(mats, bs, metric: str = "product",
                               backend: str = "auto", grid=None,
                               device=None):
    """Full §6.6 pipeline for B systems: one batched AWPM solve (local on
    ``device``, or on the process grid when ``grid`` is given) computes
    all row permutations, then each system is equilibrated, permuted and
    factorized (the LU itself stays per-matrix numpy — the matching is the
    batched hot path). Returns (xs [B, n], awac_iters [B])."""
    perms, iters = batched_pivot_permutations(mats, metric=metric,
                                              backend=backend, grid=grid,
                                              device=device)
    xs = [static_pivot_solve(a, b, perm)
          for a, b, perm in zip(mats, bs, perms)]
    return np.stack(xs), iters
