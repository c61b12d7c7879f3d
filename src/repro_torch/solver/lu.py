"""Dependency-light sparse LU with threshold/static pivoting.

This is deliberately NOT a SuperLU clone — it is the smallest factorization
that makes the paper's claim *measurable*: that a heavy-weight perfect
matching (AWPM/MC64) applied as a **static** row permutation + scaling
replaces numerical pivoting. To measure that we need a factorization that

- can run with numerical pivoting OFF (``mode="static"``: pivots are taken
  from the diagonal as-given, exactly what a distributed solver does after
  committing to the matching-based permutation), and
- tracks the two quantities the sparse-direct literature reports:
  **fill-in** (nnz(L) + nnz(U) vs nnz(A)) and **pivot growth**
  (max|U| / max|A|) — the stability proxy that explodes when static pivots
  are bad and stays O(1) when the matching put the heavy entries on the
  diagonal.

Static mode uses SuperLU's GESP trick: a pivot whose magnitude falls below
``sqrt(eps(dtype)) * max|A|`` is *perturbed* up to that floor (sign/phase
preserved) instead of aborting — the factorization always completes, and
iterative refinement (``repro_torch.solver.refine``) either repairs the
perturbation or diverges, which is the honest, observable failure mode.
``mode="threshold"`` is the classical comparison arm: partial pivoting
that accepts the diagonal when it is within ``threshold`` of the column
max (threshold=1.0 == plain partial pivoting).

Everything is host numpy, rows held as dicts during elimination
(right-looking, values exactly reproducible run-to-run); CSR in/out.
Intended for the fixture/experiment scale (n up to a few thousand), not
for HPC-scale matrices — the measurement, not the speed, is the point.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CsrMatrix", "LUFactorization", "LUStats", "sparse_lu"]

MODES = ("static", "threshold")


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Minimal CSR triple (no scipy dependency). ``data`` is float64 or
    complex128; rows are sorted by column index."""

    n: int
    indptr: np.ndarray  # [n + 1] int64
    indices: np.ndarray  # [nnz] int64
    data: np.ndarray  # [nnz]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=self.data.dtype)
        for i in range(self.n):
            lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
            out[i, self.indices[lo:hi]] = self.data[lo:hi]
        return out

    @staticmethod
    def from_coo(row, col, val, n: int) -> "CsrMatrix":
        row = np.asarray(row, np.int64)
        col = np.asarray(col, np.int64)
        val = np.asarray(val)
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(row, minlength=n), out=indptr[1:])
        return CsrMatrix(n=n, indptr=indptr, indices=col,
                         data=np.array(val, copy=True))


@dataclasses.dataclass(frozen=True)
class LUStats:
    """The two headline sparse-direct metrics plus the pivoting audit
    trail. ``fill_ratio`` counts L's implicit unit diagonal once (in U)."""

    n: int
    nnz_in: int
    nnz_l: int  # strict lower triangle of L (unit diag not stored)
    nnz_u: int
    fill_ratio: float  # (nnz_l + nnz_u) / nnz_in
    pivot_growth: float  # max|U| / max|A|
    min_pivot: float  # smallest |pivot| actually used (post-perturbation)
    perturbed_pivots: int  # static mode: pivots bumped to the GESP floor
    swaps: int  # threshold mode: rows moved off the diagonal
    mode: str


@dataclasses.dataclass(frozen=True)
class LUFactorization:
    """``P_internal A = L U`` where ``row_perm[k]`` is the input row
    eliminated at step k (identity in static mode — that is the contract:
    static pivoting commits to the caller's permutation). ``L`` stores the
    strict lower triangle (unit diagonal implicit); ``U`` includes the
    diagonal pivots."""

    L: CsrMatrix
    U: CsrMatrix
    row_perm: np.ndarray  # [n] int64
    stats: LUStats


def _pivot_floor(amax: float, dtype) -> float:
    # GESP perturbation floor: sqrt(eps) of the SOLVE precision times
    # max|A|. The solve runs factors in float32/complex64 downstream, so
    # eps(float32) is the honest scale even though elimination is f64.
    del dtype
    return float(np.sqrt(np.finfo(np.float32).eps)) * amax


def sparse_lu(a: CsrMatrix, mode: str = "static",
              threshold: float = 0.1) -> LUFactorization:
    """Factor ``a`` (square CSR) as ``P A = L U``.

    ``mode="static"``: no row exchanges ever — pivot k is entry (k, k) of
    the matrix AS GIVEN, perturbed up to the GESP floor when too small.
    ``mode="threshold"``: threshold partial pivoting — at step k the
    diagonal row keeps the pivot if ``|a_kk| >= threshold * max_r |a_rk|``,
    else the max row is swapped in; a structurally zero column raises.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not 0.0 < threshold <= 1.0:
        raise ValueError(f"threshold must be in (0, 1], got {threshold}")
    n = a.n
    complex_in = np.iscomplexobj(a.data)
    work_dtype = np.complex128 if complex_in else np.float64
    amax = float(np.abs(a.data).max()) if a.nnz else 0.0
    if amax == 0.0:
        raise ValueError("cannot factor an all-zero matrix")
    floor = _pivot_floor(amax, work_dtype)

    # rows as dicts {col: val}; `where` is the current position of each
    # original row (threshold swaps permute positions, not data)
    rows = []
    for i in range(n):
        lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
        rows.append(dict(zip(a.indices[lo:hi].tolist(),
                             a.data[lo:hi].astype(work_dtype).tolist())))
    pos_to_orig = list(range(n))

    l_rows = [dict() for _ in range(n)]  # keyed by ORIGINAL row index
    u_indptr = np.zeros(n + 1, np.int64)
    u_indices, u_data = [], []
    perturbed = swaps = 0
    min_pivot = np.inf
    u_max = 0.0

    for k in range(n):
        if mode == "threshold":
            # column max over the not-yet-eliminated positions
            best_pos, best_mag = -1, 0.0
            for p in range(k, n):
                v = rows[pos_to_orig[p]].get(k)
                if v is not None and abs(v) > best_mag:
                    best_pos, best_mag = p, abs(v)
            if best_pos < 0:
                raise ValueError(
                    f"structurally singular at column {k}: no remaining "
                    f"row has an entry there")
            diag_mag = abs(rows[pos_to_orig[k]].get(k, 0.0))
            if diag_mag < threshold * best_mag:
                pos_to_orig[k], pos_to_orig[best_pos] = \
                    pos_to_orig[best_pos], pos_to_orig[k]
                swaps += 1
        piv_row = pos_to_orig[k]
        work = rows[piv_row]
        pivot = work.get(k, work_dtype(0.0))
        if mode == "threshold":
            # partial pivoting already maximized the pivot: only a
            # genuinely negligible one (f64 round-off scale) is singular
            if abs(pivot) <= n * np.finfo(np.float64).eps * amax:
                raise ValueError(
                    f"numerically singular at step {k}: best pivot "
                    f"{abs(pivot):.3e} is round-off against max|A| "
                    f"{amax:.3e} even with partial pivoting")
        elif abs(pivot) < floor:
            # GESP: bump to the floor, keep sign/phase, count it
            phase = pivot / abs(pivot) if abs(pivot) > 0.0 else 1.0
            pivot = work_dtype(phase * floor)
            work[k] = pivot
            perturbed += 1
        min_pivot = min(min_pivot, abs(pivot))

        # U row k: cols >= k of the pivot row
        u_cols = sorted(c for c in work if c >= k)
        u_indptr[k + 1] = u_indptr[k] + len(u_cols)
        u_indices.extend(u_cols)
        for c in u_cols:
            u_data.append(work[c])
            u_max = max(u_max, abs(work[c]))
        u_row = [(c, work[c]) for c in u_cols if c > k]

        # eliminate col k from every remaining row (right-looking update)
        for p in range(k + 1, n):
            r = pos_to_orig[p]
            tgt = rows[r]
            v = tgt.pop(k, None)
            if v is None:
                continue
            mult = v / pivot
            l_rows[r][k] = mult
            for c, uv in u_row:
                nv = tgt.get(c, work_dtype(0.0)) - mult * uv
                if nv == 0.0:
                    tgt.pop(c, None)  # exact cancellation: drop, keep
                else:  # the fill count value-honest
                    tgt[c] = nv
        rows[piv_row] = {}  # eliminated; free the memory

    # assemble L in elimination order (position space): row k of L holds
    # the multipliers of the row eliminated at step k
    l_indptr = np.zeros(n + 1, np.int64)
    l_indices, l_data = [], []
    for k in range(n):
        lr = l_rows[pos_to_orig[k]]
        cols = sorted(lr)
        l_indptr[k + 1] = l_indptr[k] + len(cols)
        l_indices.extend(cols)
        l_data.extend(lr[c] for c in cols)

    row_perm = np.asarray(pos_to_orig, np.int64)
    L = CsrMatrix(n=n, indptr=l_indptr,
                  indices=np.asarray(l_indices, np.int64),
                  data=np.asarray(l_data, work_dtype))
    U = CsrMatrix(n=n, indptr=u_indptr,
                  indices=np.asarray(u_indices, np.int64),
                  data=np.asarray(u_data, work_dtype))
    stats = LUStats(
        n=n, nnz_in=a.nnz, nnz_l=L.nnz, nnz_u=U.nnz,
        fill_ratio=(L.nnz + U.nnz) / max(a.nnz, 1),
        pivot_growth=u_max / amax,
        min_pivot=float(min_pivot),
        perturbed_pivots=perturbed, swaps=swaps, mode=mode)
    return LUFactorization(L=L, U=U, row_perm=row_perm, stats=stats)
