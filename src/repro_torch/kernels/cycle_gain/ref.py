"""The plain torch version of K3 (the counterpart of the JAX package's
``kernels/cycle_gain/ref.py``): it materialises the [M, N] gain matrix.

    W[i, j] = ((a[i, j] + a2[i, j]) - u[i]) - v[j]

(the reference's order of additions) where a[i, j] != 0 and
a2[i, j] != 0, else -inf; the column max, and the smallest row reaching
it, or -1 where the column has no finite entry.
"""
from __future__ import annotations

import torch

NEG = float("-inf")
INT32_MAX = torch.iinfo(torch.int32).max


def cycle_gain_plain(a, a2, u, v):
    """a, a2 [M, N] float32 (0.0 = absent); u [M]; v [N]. Returns (gain [N]
    float32, row [N] int32)."""
    mask = (a != 0.0) & (a2 != 0.0)
    w = a + a2 - u[:, None] - v[None, :]
    w = torch.where(mask, w, NEG)
    g = w.amax(dim=0)
    rows = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    hit = (w == g[None, :]) & (g > NEG)[None, :]
    r = torch.where(hit, rows[:, None], INT32_MAX).amin(dim=0)
    return g, torch.where(g > NEG, r, -1).to(torch.int32)
