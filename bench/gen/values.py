"""The values of a cell's matrices for each call, made on the device, one
pattern (one lane) at a time.

``fresh``: a frozen PyTorch rewrite of ``repro_torch.core.graph.generate``'s
weights (``src/repro_torch/core/graph.py``; its draws are not numpy's), by
the pattern's kind (``RANGES``), on every entry, so that the answer moves
with the values:

- ``uniform``, ``banded``, ``powerlaw``: U(1e-3, 1) (``graph.py:135-136``);
- ``circuit``: the planted permutation's entries U(0.8, 1), the rest
  U(0, 0.5), a heavy planted diagonal (``graph.py:126-129``);
- ``antigreedy``: the planted entries U(0.5, 0.6), the rest U(0.9, 1), so
  that greedy locks the wrong edges (``graph.py:130-134``);

then, as the paper's section 6.1 normalises them, each row divided by its
largest entry and then each column by its own (``graph.py:71-81``), in
float64, served as float32.

``perturbed``: a frozen copy of ``repro_torch.serving.loadgen.perturbed``
without its structural churn: the previous values times
``1 + jitter * N(0, 1)``, made positive (absolute value, at least 1e-6),
in float64, served as float32.

Padding entries hold 0.
"""
from __future__ import annotations

import torch

from bench.gen.pattern import Pattern
from bench.gen.seeds import generator

F64 = torch.float64
#: kind -> (range of the planted entries, range of the rest), before the
#: normalisation; a kind not named draws every entry from ``DEFAULT``
DEFAULT = (1e-3, 1.0)
RANGES = {"circuit": ((0.8, 1.0), (0.0, 0.5)),
          "antigreedy": ((0.5, 0.6), (0.9, 1.0))}


def raw(p: Pattern, seed: int, call: int) -> torch.Tensor:
    """Call ``call``'s values as drawn, before the normalisation: [nnz]
    float64."""
    dev = p.row.device
    g = generator(dev, seed, "values", call)
    u = torch.rand(p.nnz, generator=g, dtype=F64, device=dev)
    (plo, phi), (lo, hi) = RANGES.get(p.kind, (DEFAULT, DEFAULT))
    v = lo + (hi - lo) * u
    if p.kind in RANGES:
        v = torch.where(p.planted[:p.nnz], plo + (phi - plo) * u, v)
    return v


def fresh(p: Pattern, seed: int, call: int) -> torch.Tensor:
    """Call ``call``'s values drawn anew: [cap] float32."""
    dev = p.row.device
    m = p.nnz
    v = raw(p, seed, call)
    row, col = p.row[:m].long(), p.col[:m].long()
    top = torch.zeros(p.n, dtype=F64, device=dev)
    top = top.scatter_reduce(0, row, v, "amax", include_self=True)
    v = v / top[row].clamp(min=1e-300)
    top = torch.zeros(p.n, dtype=F64, device=dev)
    top = top.scatter_reduce(0, col, v, "amax", include_self=True)
    v = v / top[col].clamp(min=1e-300)
    out = torch.zeros(p.cap, dtype=torch.float32, device=dev)
    out[:m] = v.to(torch.float32)
    return out


def perturbed(p: Pattern, prev: torch.Tensor, jitter: float, seed: int,
              call: int) -> torch.Tensor:
    """Call ``call``'s values as a repeat of the previous call's: [cap]
    float32."""
    dev = p.row.device
    g = generator(dev, seed, "jitter", call)
    m = p.nnz
    noise = torch.randn(m, generator=g, dtype=F64, device=dev)
    v = (prev[:m].to(F64) * (1.0 + jitter * noise)).abs().clamp(min=1e-6)
    out = torch.zeros_like(prev)
    out[:m] = v.to(torch.float32)
    return out
