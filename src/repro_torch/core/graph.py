"""Bipartite graph/matrix structures + synthetic matrix suite.

The paper evaluates on UF sparse collection matrices (offline here); the
generators below reproduce the structural families of Table 6.1 (circuit
simulation, FEM/structural banded-symmetric, power-law) while *guaranteeing*
full structural rank by planting a hidden random permutation — matching the
paper's assumption that a perfect matching exists.

Weights are normalized as in §6.1: each row/column max is 1 and all entries
are bounded by 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BipartiteGraph:
    """Edge-list (COO) view of a square sparse matrix; padded, shape-static.

    Padding entries carry row = col = n, val = 0.
    """

    n: int
    nnz: int
    row: np.ndarray  # [cap] int32
    col: np.ndarray  # [cap] int32
    val: np.ndarray  # [cap] float32 (weights; paper uses |a_ij| post-normalization)

    @property
    def capacity(self) -> int:
        return int(self.row.shape[0])

    def to_dense(self, fill=0.0) -> np.ndarray:
        a = np.full((self.n, self.n), fill, dtype=np.float64)
        m = np.arange(self.capacity) < self.nnz
        a[self.row[m], self.col[m]] = self.val[m]
        return a

    def structure_dense(self) -> np.ndarray:
        s = np.zeros((self.n, self.n), dtype=bool)
        m = np.arange(self.capacity) < self.nnz
        s[self.row[m], self.col[m]] = True
        return s


def _dedupe(row, col, val):
    key = row.astype(np.int64) * (col.max() + 1 if col.size else 1) + col
    _, idx = np.unique(key, return_index=True)
    return row[idx], col[idx], val[idx]


def from_coo(row, col, val, n, capacity=None, pad_align: int = 8) -> BipartiteGraph:
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    nnz = int(row.shape[0])
    if capacity is None:
        capacity = max(((nnz + pad_align - 1) // pad_align) * pad_align, pad_align)
    pad = capacity - nnz
    row = np.concatenate([row, np.full(pad, n, np.int32)])
    col = np.concatenate([col, np.full(pad, n, np.int32)])
    val = np.concatenate([val, np.zeros(pad, np.float32)])
    return BipartiteGraph(n=n, nnz=nnz, row=row, col=col, val=val)


def normalize_rowcol_max(row, col, val):
    """Paper §6.1 normalization: max entry of each row/column is 1, entries <= 1."""
    val = np.abs(val).astype(np.float64)
    n = int(max(row.max(), col.max())) + 1 if row.size else 0
    rmax = np.zeros(n)
    np.maximum.at(rmax, row, val)
    val = val / np.maximum(rmax[row], 1e-300)
    cmax = np.zeros(n)
    np.maximum.at(cmax, col, val)
    val = val / np.maximum(cmax[col], 1e-300)
    return val.astype(np.float32)


def generate(
    n: int,
    avg_degree: float = 4.0,
    kind: str = "uniform",
    seed: int = 0,
    normalize: bool = True,
) -> BipartiteGraph:
    """Synthetic square matrix with a planted perfect matching.

    kinds:
      uniform   — iid edges, iid U(0,1] weights (baseline)
      circuit   — planted diagonal heavy (like post-MC64 circuit matrices),
                  plus power-law fan-out columns
      banded    — FEM-like symmetric band (bandwidth ~ 3*avg_degree)
      powerlaw  — skewed degree distribution, adversarial for greedy
      antigreedy — weights arranged so pure greedy maximal matching is ~1/2 weight
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)  # planted perfect matching
    rows = [np.arange(n, dtype=np.int32)]
    cols = [perm]
    m_extra = int(n * max(avg_degree - 1.0, 0.0))

    if kind == "banded":
        band = max(int(3 * avg_degree), 2)
        r = rng.integers(0, n, size=m_extra).astype(np.int32)
        off = rng.integers(-band, band + 1, size=m_extra)
        c = np.clip(r + off, 0, n - 1).astype(np.int32)
    elif kind in ("powerlaw", "circuit", "antigreedy"):
        # zipf-ish column popularity
        popularity = 1.0 / (1.0 + np.arange(n)) ** 0.8
        popularity /= popularity.sum()
        r = rng.integers(0, n, size=m_extra).astype(np.int32)
        c = rng.choice(n, size=m_extra, p=popularity).astype(np.int32)
    else:
        r = rng.integers(0, n, size=m_extra).astype(np.int32)
        c = rng.integers(0, n, size=m_extra).astype(np.int32)
    rows.append(r)
    cols.append(c)
    row = np.concatenate(rows)
    col = np.concatenate(cols)

    if kind == "circuit":
        # heavy planted diagonal, weaker off-diagonals — AWPM should hit ~100%
        val = rng.uniform(0.0, 0.5, size=row.shape[0])
        val[:n] = rng.uniform(0.8, 1.0, size=n)
    elif kind == "antigreedy":
        # off-diagonal slightly heavier than planted edges so greedy locks
        # wrong edges; exercises the augmenting-cycle phase hard.
        val = rng.uniform(0.9, 1.0, size=row.shape[0])
        val[:n] = rng.uniform(0.5, 0.6, size=n)
    else:
        val = rng.uniform(1e-3, 1.0, size=row.shape[0])

    row, col, val = _dedupe(row, col, val.astype(np.float32))
    if normalize:
        val = normalize_rowcol_max(row, col, val)
    return from_coo(row, col, val, n)


SUITE_KINDS = ("uniform", "circuit", "banded", "powerlaw", "antigreedy")


def matrix_suite(n_matrices: int = 100, n: int = 120, seed: int = 0):
    """The >=100-matrix evaluation suite used for the Table 6.2 analogue."""
    out = []
    for i in range(n_matrices):
        kind = SUITE_KINDS[i % len(SUITE_KINDS)]
        deg = 3.0 + (i % 7)
        out.append(
            (
                f"{kind}_n{n}_d{deg:.0f}_s{i}",
                generate(n, avg_degree=deg, kind=kind, seed=seed + i),
            )
        )
    return out
