"""The sparsity pattern of a cell's matrix, made on the device from the
seed: a frozen PyTorch rewrite of ``repro_torch.core.graph.generate``'s
structure (its draws are not numpy's).

A square n x n pattern with exactly ``nnz`` entries: a planted random
permutation, so that a perfect matching exists, and ``nnz - n`` further
distinct entries with rows drawn uniformly and columns by ``kind``:

- ``uniform``: columns uniform (``generate``'s "uniform");
- ``powerlaw``: column j drawn with weight ``(1 + j) ** -0.8``, the
  skewed column degrees of ``generate``'s "powerlaw".

Duplicates are drawn past and dropped, then the extra entries are cut to
the count at random, so the pattern holds ``nnz`` distinct entries (where
``generate`` keeps however many survive its de-duplication). Entries are
lex-sorted by (row, col) and padded to a multiple of 8 with (n, n), the
port's convention.
"""
from __future__ import annotations

import dataclasses

import torch

from bench.gen.seeds import generator

KINDS = ("uniform", "powerlaw")
PAD_ALIGN = 8


@dataclasses.dataclass
class Pattern:
    n: int
    nnz: int
    row: torch.Tensor  # [cap] int32, lex-sorted, padding n
    col: torch.Tensor  # [cap] int32
    planted: torch.Tensor  # [cap] bool: the entry is on the permutation

    @property
    def cap(self) -> int:
        return int(self.row.shape[0])


def _columns(kind: str, count: int, n: int, g, device) -> torch.Tensor:
    if kind == "uniform":
        return torch.randint(0, n, (count,), generator=g, device=device)
    weight = (1.0 + torch.arange(n, dtype=torch.float64, device=device)
              ) ** -0.8
    cdf = torch.cumsum(weight, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(count, generator=g, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp(max=n - 1)


def make_pattern(n: int, nnz: int, kind: str, seed: int,
                 device) -> Pattern:
    """The pattern of ``seed``: the same seed gives the same pattern on
    the same kind of device."""
    if kind not in KINDS:
        raise ValueError(f"unknown pattern kind {kind!r}: expected one of "
                         f"{KINDS}")
    if not n <= nnz <= n * n:
        raise ValueError(f"nnz {nnz} must lie in [n, n * n] for n {n}")
    g = generator(device, seed, "pattern")
    perm = torch.randperm(n, generator=g, device=device)
    planted = torch.arange(n, device=device) * n + perm
    planted_sorted = torch.sort(planted).values
    want = nnz - n
    draw = want + want // 16 + 1024
    while True:
        r = torch.randint(0, n, (draw,), generator=g, device=device)
        c = _columns(kind, draw, n, g, device)
        extra = torch.unique(r * n + c)
        pos = torch.searchsorted(planted_sorted, extra).clamp(max=n - 1)
        extra = extra[planted_sorted[pos] != extra]
        if extra.numel() >= want:
            break
        draw += draw // 2
    pick = torch.randperm(extra.numel(), generator=g, device=device)[:want]
    keys, order = torch.sort(torch.cat([planted, extra[pick]]))
    cap = -(-nnz // PAD_ALIGN) * PAD_ALIGN
    row = torch.full((cap,), n, dtype=torch.int32, device=device)
    col = torch.full((cap,), n, dtype=torch.int32, device=device)
    row[:nnz] = torch.div(keys, n, rounding_mode="floor").to(torch.int32)
    col[:nnz] = (keys % n).to(torch.int32)
    mark = torch.zeros(cap, dtype=torch.bool, device=device)
    mark[:nnz] = order < n
    return Pattern(n=n, nnz=nnz, row=row, col=col, planted=mark)
