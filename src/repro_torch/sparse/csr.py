"""CSR ``row_ptr`` builders over padded lex-sorted COO edge lists, and the
windowed-search depth they imply.

The AWAC sweep turns the per-edge completion lookup into a binary search
inside one CSR row segment; these helpers build that row index on the
device and size the fixed-depth search of the plain versions.
"""
from __future__ import annotations

import math

import torch


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
