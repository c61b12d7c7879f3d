"""CSR ``row_ptr`` builders over padded lex-sorted COO edge lists, the
windowed-search depth they imply, and the host-side assembly of duplicate
COO entries.

The AWAC sweep turns the per-edge completion lookup into a binary search
inside one CSR row segment; these helpers build that row index on the
device and size the fixed-depth search of the plain versions.
"""
from __future__ import annotations

import math

import numpy as np
import torch


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
    read."""
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
