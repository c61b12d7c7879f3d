"""Embedding lookup and EmbeddingBag (the port of the JAX package's
``models/recsys/embedding.py``).

``embedding_bag`` keeps JAX's two branches: with ``use_kernel=True`` it
goes through ``kernels.embedding_bag.embedding_bag_padded``, which
launches the CUDA kernel K6 on a CUDA tensor and takes the kernel's plain
version on a CPU tensor; with ``use_kernel=False`` it is JAX's inline
gather-and-sum in plain torch. Both clip an index at or above the table's
row count to its last row and treat an index below 0 as padding.
``table`` draws a seeded item table (``embed_init(0.02)``). The
row-sharded table of the JAX package is not ported: the port runs on one
device with no mesh.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.embedding_bag.ops import embedding_bag_padded
from repro_torch.models.param import embed_init


def table(n_rows: int, dim: int, device=None,
          gen: torch.Generator | None = None) -> nn.Parameter:
    """An [n_rows, dim] float32 table drawn from ``gen`` as normal x 0.02
    (uninitialised without ``gen``)."""
    return nn.Parameter(embed_init(torch.empty(n_rows, dim, device=device),
                                   gen, 0.02))


def lookup(table, idx):
    """Plain row gather: [..., dim] rows of ``table`` at ``idx``."""
    return table[idx]


def embedding_bag(table, idx, weights, use_kernel: bool = False):
    """out[b] = sum_l weights[b, l] * table[idx[b, l]]; idx -1 = padding."""
    if use_kernel:
        return embedding_bag_padded(idx, weights, table)
    safe = idx.long().clamp(0, table.shape[0] - 1)
    rows = table[safe]
    w = torch.where(idx >= 0, weights, 0.0).to(rows.dtype)
    return (rows * w[..., None]).sum(dim=-2)
