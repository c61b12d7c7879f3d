"""Sequential reference implementations (numpy) — the oracles.

- ``exact_mwpm``: optimum MWPM via scipy's Jonker-Volgenant (the MC64-option-4
  surrogate; identical optimum).
- ``greedy_maximal``: sequential greedy maximal matching by weight.
- ``mcm_kuhn``: maximum cardinality matching (Kuhn augmenting DFS), weight-aware
  tie-breaking as in the paper's modified MCM init.
- ``sequential_awac``: the deterministic Pettie-Sanders-style Algorithm 1
  (max-gain 4-cycle per column + true greedy vertex-disjoint selection).
- ``awac_round_select``: ONE round of the *parallel* selection rule (Steps A-D,
  incl. the "rooted edge wins" discard) in plain numpy. The distributed and the
  single-device torch implementations must match this bit-for-bit; it is the
  ground truth for tests.

Conventions: square matrix, n rows == n cols. ``mate_row[j]`` = row matched to
column j; ``mate_col[i]`` = column matched to row i; sentinel ``n`` = unmatched.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.constants import MIN_GAIN

try:  # exact oracle
    from scipy.optimize import linear_sum_assignment

    HAVE_SCIPY = True
except Exception:  # pragma: no cover
    HAVE_SCIPY = False


def matching_weight(dense_val, mate_row):
    n = dense_val.shape[0]
    j = np.arange(n)
    m = mate_row < n
    return float(dense_val[mate_row[m], j[m]].sum())


def is_perfect(mate_row, n):
    return bool((np.asarray(mate_row[:n]) < n).all())


def check_matching(struct, mate_row):
    """Validity: matched edges exist, no row used twice."""
    n = struct.shape[0]
    used = mate_row[mate_row < n]
    assert len(np.unique(used)) == len(used), "row matched twice"
    for j in range(n):
        if mate_row[j] < n:
            assert struct[mate_row[j], j], f"matched edge ({mate_row[j]},{j}) missing"


def exact_mwpm(dense_val, struct):
    """Optimum-weight perfect matching on structural nonzeros. Returns
    (mate_row [n], weight). Raises if no perfect matching exists."""
    assert HAVE_SCIPY
    n = dense_val.shape[0]
    BIG = 1e9
    cost = np.where(struct, -dense_val, BIG)
    r, c = linear_sum_assignment(cost)
    if not struct[r, c].all():
        raise ValueError("no perfect matching exists")
    mate_row = np.full(n, n, dtype=np.int64)
    mate_row[c] = r
    return mate_row, float(dense_val[r, c].sum())


def greedy_maximal(dense_val, struct):
    """Sequential greedy: repeatedly take the heaviest available edge."""
    n = dense_val.shape[0]
    rr, cc = np.nonzero(struct)
    order = np.argsort(-dense_val[rr, cc], kind="stable")
    rr, cc = rr[order], cc[order]
    mate_row = np.full(n, n, dtype=np.int64)
    mate_col = np.full(n, n, dtype=np.int64)
    for i, j in zip(rr, cc):
        if mate_col[i] == n and mate_row[j] == n:
            mate_col[i] = j
            mate_row[j] = i
    return mate_row, mate_col


def mcm_kuhn(dense_val, struct, mate_row=None, mate_col=None):
    """Maximum cardinality matching via Kuhn's augmenting DFS, visiting
    neighbors heaviest-first (the paper's weight-aware tie-break)."""
    n = dense_val.shape[0]
    if mate_row is None:
        mate_row, mate_col = greedy_maximal(dense_val, struct)
    mate_row = mate_row.copy()
    mate_col = mate_col.copy()
    # adjacency: for each column, rows sorted by weight desc
    adj = []
    for j in range(n):
        rows = np.nonzero(struct[:, j])[0]
        adj.append(rows[np.argsort(-dense_val[rows, j], kind="stable")])

    def try_augment(j, vis_cols):
        for i in adj[j]:
            if vis_rows[i]:
                continue
            vis_rows[i] = True
            if mate_col[i] == n or try_augment(mate_col[i], vis_cols):
                mate_col[i] = j
                mate_row[j] = i
                return True
        return False

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, 4 * n + 100))
    try:
        for j in range(n):
            if mate_row[j] == n:
                vis_rows = np.zeros(n, dtype=bool)
                try_augment(j, None)
    finally:
        sys.setrecursionlimit(old)
    return mate_row, mate_col


def _cycle_gain(dense_val, mate_row, mate_col, i, j):
    r2 = mate_row[j]
    c2 = mate_col[i]
    return dense_val[i, j] + dense_val[r2, c2] - dense_val[i, c2] - dense_val[r2, j]


def sequential_awac(dense_val, struct, mate_row, mate_col, max_iter=1000):
    """Algorithm 1: per-column max-gain 4-cycle + greedy vertex-disjoint apply."""
    n = dense_val.shape[0]
    mate_row = mate_row.copy()
    mate_col = mate_col.copy()
    iters = 0
    for _ in range(max_iter):
        iters += 1
        S = []
        for j in range(n):
            r2 = mate_row[j]
            best = (MIN_GAIN, -1)
            for i in np.nonzero(struct[:, j])[0]:
                if i == r2:
                    continue
                c2 = mate_col[i]
                if not struct[r2, c2]:
                    continue
                g = dense_val[i, j] + dense_val[r2, c2] - dense_val[i, c2] - dense_val[r2, j]
                if g > best[0]:
                    best = (g, i)
            if best[1] >= 0:
                S.append((best[0], best[1], j))
        if not S:
            break
        S.sort(key=lambda t: (-t[0], t[2]))
        used_rows = np.zeros(n, dtype=bool)
        used_cols = np.zeros(n, dtype=bool)
        applied = 0
        for g, i, j in S:
            r2 = mate_row[j]
            c2 = mate_col[i]
            if used_rows[i] or used_rows[r2] or used_cols[j] or used_cols[c2]:
                continue
            used_rows[i] = used_rows[r2] = True
            used_cols[j] = used_cols[c2] = True
            mate_row[j] = i
            mate_col[i] = j
            mate_row[c2] = r2
            mate_col[r2] = c2
            applied += 1
        if applied == 0:
            break
    return mate_row, mate_col, iters


def find_augmenting_4cycle(dense_val, struct, mate_row, mate_col, min_gain=MIN_GAIN):
    """Any positive-gain 4-cycle, or None. Used by the 2/3-optimality property
    test (a PM with no augmenting 4-cycle is 2/3-optimal)."""
    n = dense_val.shape[0]
    for j in range(n):
        r2 = mate_row[j]
        for i in np.nonzero(struct[:, j])[0]:
            if i == r2:
                continue
            c2 = mate_col[i]
            if not struct[r2, c2]:
                continue
            g = dense_val[i, j] + dense_val[r2, c2] - dense_val[i, c2] - dense_val[r2, j]
            if g > min_gain:
                return (float(g), int(i), int(j))
    return None


def awac_round_select(dense_val, struct, mate_row, mate_col, min_gain=MIN_GAIN):
    """ONE bulk-synchronous round of the parallel selection rule.

    Returns (survivor root cols list[(i, j)], n_candidates). Mirrors Steps A-D:
      A/B: candidates = edges (i,j), i > mate_row[j], completion edge exists,
           gain > min_gain
      C:   per root column j keep max gain (tie: smallest i)
      D:   per e2-column mate_col[i] keep max gain (tie: smallest j);
           discard winners whose e2-column is itself rooted
      fallback: if all discarded but candidates exist, apply the single global
           best candidate (the paper suggests random augmentations; we use the
           deterministic best-single-cycle fallback — recorded in DESIGN.md §2)
    """
    n = dense_val.shape[0]
    jj = np.arange(n)
    ii = np.arange(n)
    v = dense_val[mate_row[jj], jj]  # weight of column j's matched edge
    u = dense_val[ii, mate_col[ii]]  # weight of row i's matched edge

    # Step A/B: all candidates
    cands = []  # (gain, i, j)
    rr, cc = np.nonzero(struct)
    r2 = mate_row[cc]
    c2 = mate_col[rr]
    exists = struct[r2, c2]
    gain = dense_val[rr, cc] + dense_val[r2, c2] - u[rr] - v[cc]
    ok = exists & (rr > r2) & (gain > min_gain)
    cands = list(zip(gain[ok], rr[ok], cc[ok]))
    if not cands:
        return [], 0

    # Step C: per-column winner (max gain, tie smallest i)
    cwin = {}
    for g, i, j in cands:
        cur = cwin.get(j)
        if cur is None or (g > cur[0]) or (g == cur[0] and i < cur[1]):
            cwin[j] = (g, i)
    rooted = set(cwin.keys())

    # Step D: group by e2col = mate_col[i]
    dwin = {}
    for j, (g, i) in cwin.items():
        e2 = int(mate_col[i])
        cur = dwin.get(e2)
        if cur is None or (g > cur[0]) or (g == cur[0] and j < cur[2]):
            dwin[e2] = (g, i, j)
    survivors = [(i, j) for e2, (g, i, j) in dwin.items() if e2 not in rooted]
    if not survivors:
        # deterministic fallback: best single cycle (tie smallest j)
        g, i, j = max(((g, i, j) for j, (g, i) in cwin.items()),
                      key=lambda t: (t[0], -t[2]))
        survivors = [(i, j)]
    survivors.sort(key=lambda t: t[1])
    return survivors, len(cands)


def apply_cycles(mate_row, mate_col, survivors):
    mate_row = mate_row.copy()
    mate_col = mate_col.copy()
    for i, j in survivors:
        r2 = mate_row[j]
        c2 = mate_col[i]
        mate_row[j] = i
        mate_col[i] = j
        mate_row[c2] = r2
        mate_col[r2] = c2
    return mate_row, mate_col


def awac_parallel_rule(dense_val, struct, mate_row, mate_col, max_iter=10000,
                       min_gain=MIN_GAIN):
    """Iterate ``awac_round_select`` to fixpoint — the numpy model of the
    full parallel algorithm. Oracle for the jnp/distributed versions."""
    mate_row = mate_row.copy()
    mate_col = mate_col.copy()
    iters = 0
    for _ in range(max_iter):
        survivors, n_cand = awac_round_select(
            dense_val, struct, mate_row, mate_col, min_gain
        )
        if not survivors:
            break
        iters += 1
        mate_row, mate_col = apply_cycles(mate_row, mate_col, survivors)
    return mate_row, mate_col, iters


def awpm_reference(dense_val, struct, max_iter=10000):
    """Full sequential AWPM: greedy -> MCM -> parallel-rule AWAC."""
    mate_row, mate_col = greedy_maximal(dense_val, struct)
    mate_row, mate_col = mcm_kuhn(dense_val, struct, mate_row, mate_col)
    if not is_perfect(mate_row, dense_val.shape[0]):
        raise ValueError("input has no perfect matching")
    mate_row, mate_col, iters = awac_parallel_rule(
        dense_val, struct, mate_row, mate_col, max_iter
    )
    return mate_row, mate_col, iters
