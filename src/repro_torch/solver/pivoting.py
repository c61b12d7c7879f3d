"""Matching -> static pivoting: permutation + MC64-style scalings.

The point of computing a heavy-weight perfect matching on ``|A|`` is that
it tells a sparse direct solver where its pivots are BEFORE factorization
(the paper's §1 motivation; SuperLU_DIST's use of MC64/AWPM). This module
turns a ``MatchResult`` into the three arrays the solver needs:

- ``row_perm`` — the row permutation placing every matched entry on the
  diagonal (``(P A)[j, j] = A[mate_row[j], j]``);
- ``dr`` / ``dc`` — row/column scaling vectors recovered from the LP-dual
  potentials of ``core.dual`` (via the public
  :meth:`~repro_torch.core.dual.DualCertificate.potentials` accessor).

The scaling recovery is the MC64 identity: with log2-scaled weights
``w_ij = log2|a_ij| - log2(max_i |a_ij|)`` and feasible duals
``u_i + v_j >= w_ij`` (tight on matched edges), setting

  ``dr_i = 2^(-u_i)``,  ``dc_j = 2^(-v_j) / max_i |a_ij|``

gives ``dr_i * |a_ij| * dc_j = 2^(w_ij - u_i - v_j) <= 1`` on EVERY entry,
with equality on matched (tight) edges. After the row permutation the
scaled matrix therefore has unit diagonal entries and everything else at
most 1 in magnitude — exactly the "dominant diagonal" a no-numerical-
pivoting factorization needs. When the certificate is not tight the
matched diagonal lands at ``2^(-slack_j) <= 1`` instead of exactly 1; the
report carries ``scaled_diag_min`` so that degradation is visible, never
silent.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ScaledPivoting",
    "awpm_pivoting",
    "from_matching",
    "identity_pivoting",
    "reference_pivoting",
]


@dataclasses.dataclass(frozen=True)
class ScaledPivoting:
    """Row permutation + row/col scalings for one n x n system.

    ``row_perm[j]`` is the ORIGINAL row index placed on diagonal position
    j of the permuted matrix. ``certificate`` is the dual certificate the
    scalings were recovered from (None for :func:`identity_pivoting`).
    """

    n: int
    row_perm: np.ndarray  # [n] int64
    dr: np.ndarray  # [n] float64 row scalings (original row order)
    dc: np.ndarray  # [n] float64 column scalings
    certificate: object = None  # DualCertificate | None
    mode: str = "none"

    def __post_init__(self):
        if sorted(self.row_perm.tolist()) != list(range(self.n)):
            raise ValueError(
                f"row_perm is not a permutation of 0..{self.n - 1} — the "
                f"matching must be perfect for static pivoting")

    @property
    def row_position(self) -> np.ndarray:
        """Inverse map: original row i lands at position row_position[i]."""
        pos = np.empty(self.n, np.int64)
        pos[self.row_perm] = np.arange(self.n, dtype=np.int64)
        return pos

    def scaled_coo(self, row, col, val):
        """COO triples of the permuted-scaled matrix
        ``P (D_r A D_c)``: entry (i, j, a) -> (pos[i], j, dr_i * a * dc_j).
        Complex values scale by the real dr/dc and keep their phase."""
        row = np.asarray(row, np.int64)
        col = np.asarray(col, np.int64)
        val = np.asarray(val)
        out_dtype = np.complex128 if np.iscomplexobj(val) else np.float64
        return (self.row_position[row], col,
                val.astype(out_dtype) * self.dr[row] * self.dc[col])

    def scale_rhs(self, b):
        """``b`` of ``A x = b`` -> the permuted-scaled system's RHS
        ``P D_r b`` (last axis is n; leading batch axes pass through)."""
        b = np.asarray(b)
        return (b * self.dr)[..., self.row_perm]

    def unscale_solution(self, y):
        """Solution ``y`` of the permuted-scaled system -> ``x = D_c y``
        solving the original ``A x = b``."""
        return np.asarray(y) * self.dc

    def scaled_diag(self, row, col, val):
        """|diagonal| of the permuted-scaled matrix (== 1 everywhere when
        the certificate is tight) — the honesty metric for how dominant
        the static pivots actually are."""
        pr, pc, pv = self.scaled_coo(row, col, val)
        diag = np.zeros(self.n, np.float64)
        on = pr == pc
        diag[pr[on]] = np.abs(pv[on])
        return diag


def _colmax_abs(col, val, n):
    a = np.abs(np.asarray(val)).astype(np.float64)  # |complex| is real
    if (a == 0.0).any():
        raise ValueError(
            "static pivoting is undefined on explicit zero entries — drop "
            "them first (repro_torch.solver.pipeline does)")
    cmax = np.zeros(n, np.float64)
    np.maximum.at(cmax, np.asarray(col), a)
    return a, cmax


def from_matching(row, col, val, n: int, mate_row,
                  mode: str = "awpm") -> ScaledPivoting:
    """Build the permutation + scalings from a perfect matching on the
    entries' magnitudes. ``val`` may be real or complex; weights and duals
    are computed on ``|val|`` in the MC64 log2-scaled metric, so the
    recovered scalings are exactly the MC64 ones when the matching is
    optimal (tight certificate)."""
    from repro_torch.core.dual import dual_certificate
    from repro_torch.data.weight_transforms import log2_scaled

    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    a, cmax = _colmax_abs(col, val, n)
    w = log2_scaled(row, col, a, n)
    cert = dual_certificate(row, col, w, n, mate_row)
    u, v = cert.potentials()
    dr = np.exp2(-u)
    dc = np.exp2(-v) / np.maximum(cmax, np.finfo(np.float64).tiny)
    perm = np.asarray(mate_row, np.int64).reshape(-1)[:n]
    return ScaledPivoting(n=n, row_perm=perm, dr=dr, dc=dc,
                          certificate=cert, mode=mode)


def identity_pivoting(n: int) -> ScaledPivoting:
    """No pivoting, no scaling — the contrast arm of the experiments."""
    return ScaledPivoting(n=n, row_perm=np.arange(n, dtype=np.int64),
                          dr=np.ones(n), dc=np.ones(n), certificate=None,
                          mode="none")


def awpm_pivoting(row, col, val, n: int, options=None, device=None):
    """The production path: AWPM matching on the MC64 log2-scaled
    magnitudes through the ``solve()`` facade on ``device`` (None: the
    card, where "auto" runs the persistent AWAC kernel), then
    :func:`from_matching` on the host. Returns ``(ScaledPivoting,
    MatchResult)``."""
    from repro_torch.core.api import MatchingProblem, SolveOptions, solve
    from repro_torch.data.weight_transforms import log2_scaled_nonneg

    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    a = np.abs(np.asarray(val))
    # the engine solves on the non-negative lift (decision-invariant,
    # f32-friendly); the certificate/scalings use the shift-free metric
    w = log2_scaled_nonneg(row, col, a, n)
    problem = MatchingProblem.from_coo(row, col, w, n, device=device)
    result = solve(problem, options or SolveOptions())
    mate = result.mate_row.cpu().numpy()[..., :n]
    return from_matching(row, col, val, n, mate, mode="awpm"), result


def reference_pivoting(row, col, val, n: int):
    """The MC64-style reference arm: EXACT maximum-weight perfect matching
    (scipy Hungarian oracle) on the same log2-scaled magnitudes, then
    :func:`from_matching` — so "AWPM vs reference" isolates the matching
    quality, with identical scaling recovery on both arms. Returns
    ``(ScaledPivoting, mate_row)``."""
    from repro_torch.core import ref
    from repro_torch.data.weight_transforms import log2_scaled

    if not ref.HAVE_SCIPY:
        raise RuntimeError(
            "reference pivoting needs scipy's linear_sum_assignment for "
            "the exact MC64-style matching — use pivoting='awpm' (no "
            "scipy dependency) or install scipy")
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    a = np.abs(np.asarray(val))
    w = log2_scaled(row, col, a, n)
    dense = np.full((n, n), -np.inf, np.float64)
    struct = np.zeros((n, n), bool)
    dense[row, col] = w
    struct[row, col] = True
    dense[~struct] = 0.0
    mate, _ = ref.exact_mwpm(dense, struct)
    return from_matching(row, col, val, n, mate, mode="reference"), mate
