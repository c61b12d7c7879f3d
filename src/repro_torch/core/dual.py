"""LP-dual certificates for heavy-weight perfect matchings (DESIGN.md §8).

The assignment LP's dual says: any potentials (u_i, v_j) with
``u_i + v_j >= w_ij`` on every edge certify ``sum(u) + sum(v) >= OPT``
(weak duality; the perfect-matching constraints are equalities, so the
duals are free-sign). That upper bound lower-bounds the approximation
ratio ``weight / bound`` WITHOUT the O(n^3) exact oracle
(``core.ref.exact_mwpm``) — the only way to audit the paper's
"very close to the optimum" claim on instances too large to solve exactly.

Construction (host numpy, O(max_rounds * m)): seed from the matching and
solve the difference-constraint system that complementary slackness
demands. Writing m_j for the matched row of column j and pinning
``u_{m_j} + v_j = w(m_j, j)`` (tight matched edges) turns feasibility on
edge (i, j) into ``u_{m_j} <= u_i + (w(m_j, j) - w_ij)`` — a shortest-path
problem over rows, solved by Bellman-Ford. It converges within n rounds
iff the constraint graph has no negative cycle, which holds exactly when
the matching admits no weight-increasing alternating cycle — i.e. when the
matching is OPTIMAL. Then ``sum(u) + sum(v) == weight`` and the
certificate is tight (ratio bound 1). For a suboptimal matching the
descent is cut off at ``max_rounds`` and feasibility is restored by
lifting each v_j by its column's worst violation — the bound stays sound,
exceeding the matching weight by the accumulated slack. The final lift
also absorbs float round-off, so soundness never rests on exact
arithmetic.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DualCertificate", "certify", "dual_certificate"]


@dataclasses.dataclass(frozen=True)
class DualCertificate:
    """Feasible dual potentials + the bound they certify.

    ``upper_bound >= OPT >= weight`` always; ``tight`` means the
    Bellman-Ford descent converged (no weight-increasing alternating
    cycle), in which case ``upper_bound == weight`` up to float round-off
    and the matching is certified optimal.
    """

    u: np.ndarray  # [n] float64 row potentials
    v: np.ndarray  # [n] float64 column potentials
    weight: float  # matched-edge weight sum (float64 recompute)
    upper_bound: float  # sum(u) + sum(v) >= optimum
    tight: bool  # descent converged -> matching certified optimal
    rounds: int  # Bellman-Ford rounds used

    @property
    def bound_valid(self) -> bool:
        """Whether ``weight / upper_bound`` is a meaningful ratio bound.
        False only for a non-converged certificate with a non-positive
        upper bound (possible in the raw log2_scaled metric, where all
        weights <= 0): there a quotient of negatives inverts the
        inequality and certifies nothing."""
        return self.tight or self.upper_bound > 0.0

    @property
    def ratio_bound(self) -> float:
        """Certified lower bound on weight / OPT (1.0 when tight).
        Raises ``ValueError`` when ``bound_valid`` is False — a silent NaN
        here used to flow into BENCH comparisons; callers that can accept
        an absent bound should use :meth:`ratio_bound_or`."""
        if self.tight:
            return 1.0
        if not self.bound_valid:
            raise ValueError(
                f"no valid ratio bound: upper_bound={self.upper_bound:.6g} "
                f"<= 0 without convergence (raw log2_scaled-style metric?). "
                f"Check bound_valid or use ratio_bound_or(); the absolute "
                f"slack ({self.slack:.6g}) is still meaningful.")
        return self.weight / self.upper_bound

    def ratio_bound_or(self, default=None):
        """``ratio_bound`` when valid, else ``default`` — the NaN-free
        accessor for reporting pipelines."""
        return self.ratio_bound if self.bound_valid else default

    @property
    def slack(self) -> float:
        """upper_bound - weight: how far from certified-optimal."""
        return self.upper_bound - self.weight

    def potentials(self) -> tuple[np.ndarray, np.ndarray]:
        """The feasible dual vectors ``(u, v)`` — row potentials first —
        as float64 copies (mutating the return never corrupts the
        certificate). This is the public accessor downstream consumers
        use (the static-pivoting solver recovers the MC64-style row/column
        scalings from these; ``experiments`` reads them for reporting):
        every potential pair satisfies ``u_i + v_j >= w_ij`` on every
        edge, with equality on matched edges when ``tight``.
        """
        return np.array(self.u, np.float64, copy=True), \
            np.array(self.v, np.float64, copy=True)


def dual_certificate(row, col, val, n: int, mate_row, *,
                     max_rounds: int | None = None,
                     refine_sweeps: int = 8,
                     tol: float = 1e-9) -> DualCertificate:
    """Certify the perfect matching ``mate_row`` on the COO instance.

    Accepts padded or raw triples (entries with row or col >= n are
    dropped) and ``mate_row`` of length n or n+1 (sentinel slot ignored);
    everything is host numpy, float64. Raises if the matching is not
    perfect or uses an edge absent from the edge list. ``max_rounds``
    caps the Bellman-Ford descent (default n — the provable convergence
    bound when the matching is optimal); ``refine_sweeps`` tightens a
    non-converged bound by dual coordinate descent (each sweep stays
    feasible and only lowers the bound); ``tol`` is the relative
    convergence/tightness threshold.
    """
    row = np.asarray(row).reshape(-1).astype(np.int64)
    col = np.asarray(col).reshape(-1).astype(np.int64)
    val = np.asarray(val).reshape(-1).astype(np.float64)
    keep = (row < n) & (col < n) & (row >= 0) & (col >= 0)
    row, col, val = row[keep], col[keep], val[keep]
    mate_row = np.asarray(mate_row).reshape(-1).astype(np.int64)[:n]
    if mate_row.shape[0] != n or (mate_row >= n).any() or (mate_row < 0).any():
        raise ValueError(
            "dual_certificate needs a PERFECT matching (every column "
            "matched); certify the output of solve() only when "
            "result.perfect is True")
    if len(np.unique(mate_row)) != n:
        raise ValueError("mate_row matches a row twice — not a matching")

    # matched-edge weights w_col[j] = w(mate_row[j], j), via one sorted
    # key lookup over the (deduped-or-not) edge list
    key = row * np.int64(n) + col
    order = np.argsort(key, kind="stable")
    skey, sval = key[order], val[order]
    jvec = np.arange(n, dtype=np.int64)
    mkey = mate_row * np.int64(n) + jvec
    pos = np.searchsorted(skey, mkey)
    pos_c = np.clip(pos, 0, max(skey.shape[0] - 1, 0))
    found = (pos < skey.shape[0]) & (skey[pos_c] == mkey)
    if not found.all():
        j_bad = int(jvec[~found][0])
        raise ValueError(
            f"matched edge ({int(mate_row[j_bad])}, {j_bad}) is not in the "
            f"edge list — matching and instance disagree")
    w_col = sval[pos_c]
    weight = float(w_col.sum())
    scale = max(1.0, float(np.abs(val).max()) if val.size else 0.0)

    # Bellman-Ford over rows on the difference constraints
    #   u[m_j] <= u[i] + (w_col[j] - w_ij)   for every edge (i, j), i != m_j
    m_j = mate_row[col]  # matched row of each edge's column
    off = row != m_j  # matched edges give the trivial u_i <= u_i
    src, tgt = row[off], m_j[off]
    delta = w_col[col[off]] - val[off]
    if max_rounds is None:
        max_rounds = n
    u = np.zeros(n, np.float64)
    rounds = 0
    converged = src.size == 0
    for rounds in range(1, max_rounds + 1):
        new_u = u.copy()
        np.minimum.at(new_u, tgt, u[src] + delta)
        improved = float((u - new_u).max()) if n else 0.0
        u = new_u
        if improved <= tol * scale:
            converged = True
            break

    # tight matched edges: v_j = w_col[j] - u[m_j]; then restore exact
    # feasibility by lifting v per column (absorbs non-convergence AND
    # float slop — soundness never depends on the loop above)
    v = w_col - u[mate_row]
    lift = np.zeros(n, np.float64)
    np.maximum.at(lift, col, val - u[row] - v[col])
    lift = np.maximum(lift, 0.0)
    v = v + lift
    tight = bool(converged and float(lift.sum()) <= tol * scale * max(n, 1))
    if not tight:
        # dual coordinate descent: u_i := max_j (w_ij - v_j) is the least
        # row potential feasible against the current v (bound can only
        # drop), then v_j := max_i (w_ij - u_i) restores feasibility
        # column-wise. Every sweep ends feasible, so soundness holds no
        # matter where we stop. Skipped when already tight: the bound is
        # the matching weight, the floor weak duality allows.
        for _ in range(max(refine_sweeps, 0)):
            u = np.full(n, -np.inf)
            np.maximum.at(u, row, val - v[col])
            u[np.isinf(u)] = 0.0  # unreachable for perfect matchings
            v = np.full(n, -np.inf)
            np.maximum.at(v, col, val - u[row])
    upper = float(u.sum() + v.sum())
    return DualCertificate(u=u, v=v, weight=weight, upper_bound=upper,
                           tight=tight, rounds=rounds)


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (on any device) or an array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def certify(problem, result, **kwargs):
    """Certify a ``solve()`` result against its ``MatchingProblem``.

    Single instance -> one :class:`DualCertificate`; batched problem ->
    a list with one certificate per instance. Host-side (numpy): the
    problem's and the result's tensors, wherever they lie, are copied to
    the host once.
    """
    row = _host(problem.row)
    col = _host(problem.col)
    val = _host(problem.val)
    mate_row = _host(result.mate_row)
    if problem.is_batched:
        return [
            dual_certificate(row[b], col[b], val[b], problem.n, mate_row[b],
                             **kwargs)
            for b in range(row.shape[0])
        ]
    return dual_certificate(row, col, val, problem.n, mate_row, **kwargs)
