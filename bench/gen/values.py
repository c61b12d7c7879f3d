"""The values of a cell's matrix for each call, made on the device.

``fresh``: a frozen PyTorch rewrite of ``repro_torch.core.graph.generate``'s
weights for its ``uniform`` and ``powerlaw`` kinds (its draws are not
numpy's): U(1e-3, 1) on every entry, the planted permutation's included,
so that the answer moves with the values; then, as the paper's section
6.1 normalises them, each row divided by its largest entry and then each
column by its own, in float64, served as float32.

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


def fresh(p: Pattern, seed: int, call: int) -> torch.Tensor:
    """Call ``call``'s values drawn anew: [cap] float32."""
    dev = p.row.device
    g = generator(dev, seed, "values", call)
    m = p.nnz
    v = 1e-3 + (1.0 - 1e-3) * torch.rand(m, generator=g, dtype=F64,
                                         device=dev)
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
