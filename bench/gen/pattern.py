"""The sparsity patterns of a cell's matrices, made on the device from the
seed: frozen PyTorch rewrites of ``repro_torch.core.graph.generate``'s
structure (``src/repro_torch/core/graph.py``; its draws are not numpy's).

A square n x n pattern with exactly ``nnz`` entries: a planted random
permutation, so that a perfect matching exists, and ``nnz - n`` further
distinct entries with rows drawn uniformly and columns by ``kind``
(``KINDS``, the kinds of ``graph.SUITE_KINDS``):

- ``uniform``: columns uniform (``graph.py:118-120``);
- ``powerlaw``, ``circuit``, ``antigreedy``: column j drawn with weight
  ``(1 + j) ** -0.8``, the skewed column degrees ``generate`` gives these
  three kinds (``graph.py:112-117``); the kinds differ in their values
  (``bench/gen/values.py``);
- ``banded``: column = row + U{-band..band}, clipped to [0, n), with
  band = max(int(3 * degree), 2) and degree = nnz / n, the FEM-like band
  of ``graph.py:107-111``.

Duplicates are drawn past and dropped, then the extra entries are cut to
the count at random, so the pattern holds ``nnz`` distinct entries (where
``generate`` keeps however many survive its de-duplication). Entries are
lex-sorted by (row, col) and padded to a multiple of 8 with (n, n), the
port's convention.

A configuration without ``batch`` is one pattern, made from the run's seed;
one with ``batch`` B and ``kinds`` is B lanes (``make_lanes``), lane i of
kind ``kinds[i % len(kinds)]`` and made from a seed of its own derived from
(seed, i).
"""
from __future__ import annotations

import dataclasses

import torch

from bench.gen.seeds import derive, generator

KINDS = ("uniform", "circuit", "banded", "powerlaw", "antigreedy")
PAD_ALIGN = 8


@dataclasses.dataclass
class Pattern:
    n: int
    nnz: int
    row: torch.Tensor  # [cap] int32, lex-sorted, padding n
    col: torch.Tensor  # [cap] int32
    planted: torch.Tensor  # [cap] bool: the entry is on the permutation
    kind: str
    seed: int  # the pattern's seed, which its values are drawn from too

    @property
    def cap(self) -> int:
        return int(self.row.shape[0])


def band_of(n: int, nnz: int) -> int:
    """``banded``'s half-width at degree nnz / n (``graph.py:108``)."""
    return max(int(3 * nnz / n), 2)


def _columns(kind: str, r: torch.Tensor, n: int, band: int,
             g) -> torch.Tensor:
    count, device = r.numel(), r.device
    if kind == "uniform":
        return torch.randint(0, n, (count,), generator=g, device=device)
    if kind == "banded":
        off = torch.randint(-band, band + 1, (count,), generator=g,
                            device=device)
        return (r + off).clamp(0, n - 1)
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
    band = band_of(n, nnz)
    perm = torch.randperm(n, generator=g, device=device)
    planted = torch.arange(n, device=device) * n + perm
    planted_sorted = torch.sort(planted).values
    want = nnz - n
    draw = want + want // 16 + 1024
    while True:
        r = torch.randint(0, n, (draw,), generator=g, device=device)
        c = _columns(kind, r, n, band, g)
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
    return Pattern(n=n, nnz=nnz, row=row, col=col, planted=mark, kind=kind,
                   seed=seed)


def make_lanes(config: dict, seed: int, device) -> list[Pattern]:
    """A configuration's instances: without ``batch``, the one pattern of
    ``seed`` and the configuration's ``pattern`` kind; with it, ``batch``
    lanes of ``n`` and ``nnz`` each, lane i of kind ``kinds[i % len(kinds)]``
    made from the seed derived from (``seed``, i)."""
    n, nnz = int(config["n"]), int(config["nnz"])
    if "batch" not in config:
        return [make_pattern(n, nnz, config["pattern"], seed, device)]
    b, kinds = int(config["batch"]), list(config["kinds"])
    if b < 1 or not kinds:
        raise ValueError(f"a batched configuration needs batch >= 1 and a "
                         f"kind, got batch {b} and kinds {kinds}")
    return [make_pattern(n, nnz, kinds[i % len(kinds)],
                         derive(seed, "lane", i), device) for i in range(b)]
