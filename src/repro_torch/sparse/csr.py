"""CSR ``row_ptr`` builders over padded lex-sorted COO edge lists, the
windowed-search depth they imply, the host-side assembly of duplicate
COO entries, and the padded CSR of the data pipeline (``PaddedCSR``,
``sort_coo``, ``coo_to_padded_csr``; numpy, copies of the JAX package's).

The AWAC sweep turns the per-edge completion lookup into a binary search
inside one CSR row segment; these helpers build that row index on the
device and size the fixed-depth search of the plain versions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs


@dataclasses.dataclass
class PaddedCSR:
    """CSR with a fixed nnz capacity. Entries [nnz:] are padding with
    row = n_rows, col = n_cols, val = 0 so that segment ops drop them.

    Also carries the COO row array (sorted) because the matching
    algorithms are edge-centric.
    """

    n_rows: int
    n_cols: int
    nnz: int
    row_ptr: np.ndarray  # [n_rows + 1] int32
    row: np.ndarray  # [cap] int32, sorted
    col: np.ndarray  # [cap] int32, sorted within rows
    val: np.ndarray  # [cap] float32

    @property
    def capacity(self) -> int:
        return int(self.row.shape[0])

    def valid_mask(self) -> np.ndarray:
        return np.arange(self.capacity) < self.nnz


def sort_coo(row, col, val):
    """Sort COO triples lexicographically by (row, col)."""
    order = np.lexsort((col, row))
    return row[order], col[order], val[order]


def coo_to_padded_csr(row, col, val, n_rows, n_cols,
                      capacity=None) -> PaddedCSR:
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    val = np.asarray(val, dtype=np.float32)
    nnz = int(row.shape[0])
    if capacity is None:
        capacity = nnz
    if capacity < nnz:
        raise ValueError(f"capacity {capacity} < nnz {nnz}")
    row, col, val = sort_coo(row, col, val)
    counts = np.bincount(row, minlength=n_rows)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    pad = capacity - nnz
    row = np.concatenate([row, np.full(pad, n_rows, dtype=np.int32)])
    col = np.concatenate([col, np.full(pad, n_cols, dtype=np.int32)])
    val = np.concatenate([val, np.zeros(pad, dtype=np.float32)])
    return PaddedCSR(n_rows, n_cols, nnz, row_ptr, row, col, val)


def dedupe_coo_sum(row, col, val, n_cols=None):
    """Assemble duplicate COO entries by summation (numpy, host-side).

    Returns lex-sorted (row, col, val) with one entry per (row, col) pair,
    duplicate values summed: the Matrix Market assembly convention for
    repeated coordinate entries (and FEM-style element assembly). Unlike
    ``repro_torch.core.graph._dedupe`` (keep-first), no value is dropped.
    """
    row = np.asarray(row)
    col = np.asarray(col)
    val = np.asarray(val)
    if row.size == 0:
        return row, col, val
    if n_cols is None:
        n_cols = int(col.max()) + 1
    key = row.astype(np.int64) * np.int64(n_cols) + col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq_mask = np.empty(key.shape, bool)
    uniq_mask[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
    seg = np.cumsum(uniq_mask) - 1  # dense segment id per sorted entry
    out_val = np.zeros(int(seg[-1]) + 1, dtype=np.result_type(val, np.float64))
    np.add.at(out_val, seg, val[order])
    first = order[uniq_mask]
    return row[first], col[first], out_val.astype(val.dtype, copy=False)


def row_ptr_from_sorted(row: torch.Tensor, n: int) -> torch.Tensor:
    """CSR ``row_ptr`` [n + 2] int32 from a padded lex-sorted COO row array
    [cap] (padding rows == n). ``row_ptr[i]`` is the first edge index with
    ``row >= i``; ``row_ptr[n]`` is the start of the padding tail and
    ``row_ptr[n + 1]`` the capacity."""
    targets = torch.arange(n + 2, dtype=row.dtype, device=row.device)
    return torch.searchsorted(row.contiguous(), targets, side="left",
                              out_int32=True)


def batched_row_ptr_from_sorted(row: torch.Tensor, n: int) -> torch.Tensor:
    """Per-instance ``row_ptr`` [B, n + 2] from a batch of padded
    lex-sorted COO row arrays [B, cap]; row b equals
    ``row_ptr_from_sorted(row[b], n)``."""
    b = row.shape[0]
    targets = torch.arange(n + 2, dtype=row.dtype, device=row.device)
    return torch.searchsorted(row.contiguous(),
                              targets.expand(b, n + 2).contiguous(),
                              side="left", out_int32=True)


def window_depth(max_row_nnz: int) -> int:
    """Binary-search rounds needed to resolve a window of ``max_row_nnz``
    entries (one extra round closes half-open intervals)."""
    return max(1, math.ceil(math.log2(max(int(max_row_nnz), 1))) + 1)


def max_row_nnz(row: torch.Tensor, n: int) -> int:
    """Max nonzeros in any row of a padded COO row array — [cap], or
    [B, cap] for a batch, in which case the max is taken across all
    instances (each instance's rows counted separately). One device-to-host
    read (span ``d2h.row_nnz``, which also holds the syncs of the masked
    select and of ``bincount``)."""
    with obs.d2h("row_nnz"):
        if row.dim() == 2:
            offs = torch.arange(row.shape[0], device=row.device,
                                dtype=torch.int64)[:, None] * n
            real = row < n
            r = (row.to(torch.int64) + offs)[real]
        else:
            r = row[row < n].to(torch.int64)
        if r.numel() == 0:
            return 1
        return int(torch.bincount(r).max().item())
