"""2D block partitioning of a sparse matrix over a Pr x Pc process grid.

The paper's CombBLAS-style regular 2D distribution: process (a, b) owns the
dense index block rows [a*br, (a+1)*br) x cols [b*bc, (b+1)*bc). Per-block
edge lists are padded to a common capacity and stacked [Pr, Pc, cap]
(or [Pr, Pc, B, cap] for a batch), so rank ``a * pc + b`` takes block
[a, b].

Entries store GLOBAL indices (int32). Padding entries have row = col = n
(the global sentinel) and val = 0; every consumer masks on ``row < n``.
numpy only: every rank partitions the same problem on the host and gets
the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Partition2D:
    n: int  # global rows == cols (square, per the paper)
    pr: int
    pc: int
    br: int  # block rows  = ceil(n / pr)
    bc: int  # block cols  = ceil(n / pc)
    cap: int  # per-block edge capacity
    nnz: np.ndarray  # [pr, pc] int32 actual nnz per block
    row: np.ndarray  # [pr, pc, cap] int32 global row ids, lex-sorted per block
    col: np.ndarray  # [pr, pc, cap] int32 global col ids
    val: np.ndarray  # [pr, pc, cap] float32

    def block_of(self, i, j):
        return i // self.br, j // self.bc


@dataclasses.dataclass
class Partition2DBatched:
    """A batch of B instances partitioned over the SAME Pr x Pc grid with a
    shared per-block capacity, stacked [pr, pc, B, cap]: each rank holds
    its block of every instance, so the batched collectives amortize
    across B."""

    n: int
    b: int
    pr: int
    pc: int
    br: int
    bc: int
    cap: int  # shared per-block edge capacity (true max occupancy, padded)
    nnz: np.ndarray  # [pr, pc, B] int32 actual nnz per (block, instance)
    row: np.ndarray  # [pr, pc, B, cap] int32 global rows, lex-sorted per block
    col: np.ndarray  # [pr, pc, B, cap] int32 global cols
    val: np.ndarray  # [pr, pc, B, cap] float32


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def block_occupancy(row, col, n: int, pr: int, pc: int) -> np.ndarray:
    """True per-block nnz counts of a padded COO instance ([cap] arrays,
    padding row == n) or batch ([B, cap]). Returns [pr, pc] (or
    [B, pr, pc]). Capacity planning must rest on this measurement: the
    uniform m / (pr * pc) estimate undercounts skewed instances (one dense
    row lands entirely in a single grid row)."""
    row = np.asarray(row)
    col = np.asarray(col)
    if row.ndim == 2:
        return np.stack([
            block_occupancy(r, c, n, pr, pc) for r, c in zip(row, col)
        ])
    br = -(-n // pr)
    bc = -(-n // pc)
    m = row < n
    blk = (row[m] // br) * pc + col[m] // bc
    return np.bincount(blk, minlength=pr * pc).reshape(pr, pc).astype(np.int32)


def plan_block_cap(row, col, n: int, pr: int, pc: int,
                   pad_align: int = 8) -> int:
    """Per-block edge capacity derived from the TRUE max block occupancy
    (never the uniform nnz / (pr * pc) spread). Accepts [cap] or [B, cap]
    padded COO index arrays."""
    occ = int(block_occupancy(row, col, n, pr, pc).max(initial=0))
    return max(_round_up(occ, pad_align), pad_align)


def partition_coo_2d(
    row, col, val, n: int, pr: int, pc: int, cap: int | None = None,
    pad_align: int = 8,
) -> Partition2D:
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    br = -(-n // pr)
    bc = -(-n // pc)
    a = row // br
    b = col // bc
    blk = a * pc + b
    order = np.lexsort((col, row, blk))
    row, col, val, blk = row[order], col[order], val[order], blk[order]
    counts = np.bincount(blk, minlength=pr * pc)
    max_nnz = int(counts.max()) if counts.size else 0
    if cap is None:
        cap = max(_round_up(max_nnz, pad_align), pad_align)
    if cap < max_nnz:
        raise ValueError(
            f"cap {cap} < max block nnz {max_nnz}: refusing to truncate "
            f"edges (capacity must come from true block occupancy, see "
            f"plan_block_cap)")
    R = np.full((pr * pc, cap), n, dtype=np.int32)
    C = np.full((pr * pc, cap), n, dtype=np.int32)
    V = np.zeros((pr * pc, cap), dtype=np.float32)
    starts = np.zeros(pr * pc + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for p in range(pr * pc):
        s, e = starts[p], starts[p + 1]
        R[p, : e - s] = row[s:e]
        C[p, : e - s] = col[s:e]
        V[p, : e - s] = val[s:e]
    return Partition2D(
        n=n, pr=pr, pc=pc, br=br, bc=bc, cap=cap,
        nnz=counts.reshape(pr, pc).astype(np.int32),
        row=R.reshape(pr, pc, cap),
        col=C.reshape(pr, pc, cap),
        val=V.reshape(pr, pc, cap),
    )


def _block_order(r, c, blk, single_block: bool):
    """The order that sorts edges by (block, row, col). Edges that already
    come lex-sorted by (row, col), as a ``MatchingProblem`` holds them,
    need only a stable sort by block (none for a single block); the
    result equals the full three-key sort either way."""
    lex = r.size < 2 or bool(np.all(
        (r[1:] > r[:-1]) | ((r[1:] == r[:-1]) & (c[1:] >= c[:-1]))))
    if not lex:
        return np.lexsort((c, r, blk))
    if single_block:
        return None
    return np.argsort(blk, kind="stable")


def partition_coo_2d_batched(
    row, col, val, n: int, pr: int, pc: int, cap: int | None = None,
    pad_align: int = 8,
) -> Partition2DBatched:
    """Partition a batch of padded [B, cap_in] COO instances (shared n,
    padding entries (n, n, 0)) over one Pr x Pc grid with a SHARED
    per-block capacity.

    ``cap=None`` derives the capacity from the true max block occupancy
    across every (instance, block) pair (``plan_block_cap``). An explicit
    ``cap`` smaller than that occupancy raises: edges are never silently
    truncated, because a dropped edge would degrade the matching weight on
    exactly the skewed instances.
    """
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    if row.ndim != 2:
        raise ValueError(f"expected batched [B, cap] arrays, got {row.shape}")
    b = row.shape[0]
    br = -(-n // pr)
    bc = -(-n // pc)
    occ = block_occupancy(row, col, n, pr, pc)  # [B, pr, pc]
    max_occ = int(occ.max(initial=0))
    if cap is None:
        cap = max(_round_up(max_occ, pad_align), pad_align)
    if cap < max_occ:
        raise ValueError(
            f"cap {cap} < max block occupancy {max_occ}: refusing to "
            f"truncate edges (derive capacity with plan_block_cap)")
    R = np.full((pr * pc, b, cap), n, dtype=np.int32)
    C = np.full((pr * pc, b, cap), n, dtype=np.int32)
    V = np.zeros((pr * pc, b, cap), dtype=np.float32)
    for i in range(b):
        m = row[i] < n
        r, c, v = row[i][m], col[i][m], val[i][m]
        blk = (r // br) * pc + c // bc
        order = _block_order(r, c, blk, pr * pc == 1)
        if order is not None:
            r, c, v, blk = r[order], c[order], v[order], blk[order]
        counts = np.bincount(blk, minlength=pr * pc)
        starts = np.zeros(pr * pc + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        for p in range(pr * pc):
            s, e = starts[p], starts[p + 1]
            R[p, i, : e - s] = r[s:e]
            C[p, i, : e - s] = c[s:e]
            V[p, i, : e - s] = v[s:e]
    return Partition2DBatched(
        n=n, b=b, pr=pr, pc=pc, br=br, bc=bc, cap=cap,
        nnz=np.transpose(occ, (1, 2, 0)).astype(np.int32),
        row=R.reshape(pr, pc, b, cap),
        col=C.reshape(pr, pc, b, cap),
        val=V.reshape(pr, pc, b, cap),
    )
