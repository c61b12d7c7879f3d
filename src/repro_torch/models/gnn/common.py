"""GNN substrate (the port of the JAX package's ``models/gnn/common.py``):
``GraphBatch``, message passing over segment sums and maxes, the radial
and spherical bases, and the shared loss head.

Message passing is a gather (``take``, an ``index_select``) and a
scatter-sum (``sparse.ops.segment_sum``, over ``index_add``), as the JAX
package writes it with ``jnp.take`` and ``jax.ops.segment_sum``. Edge padding
carries ``src = dst = n_nodes``; every reduction runs over ``n_nodes + 1``
segments and drops the sentinel row, since ``index_add`` refuses the
out-of-range ids that ``jax.ops.segment_sum`` would silently drop.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, softmax_xent
from repro_torch.sparse.ops import segment_max, segment_sum


def as_tensor(x, device):
    """A numpy array (or tensor) as a tensor on ``device``; None stays."""
    if x is None:
        return None
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device)


@dataclasses.dataclass
class GraphBatch:
    """Generic padded graph. Edge padding: src = dst = n_nodes (sentinel
    row dropped by segment ops). ``graph_id`` batches small graphs
    (molecule shape); None for single graphs. ``n_graphs`` is static.
    The data pipeline fills it with numpy arrays; ``to`` gives the same
    batch as tensors on a device."""

    node_feat: torch.Tensor  # [N, F]
    edge_src: torch.Tensor  # [E] int32
    edge_dst: torch.Tensor  # [E] int32
    labels: torch.Tensor  # [N] int32 (node class) or [G, n_out] f32
    coords: torch.Tensor | None = None  # [N, 3]
    graph_id: torch.Tensor | None = None  # [N] int32 graph membership
    triplets: tuple | None = None  # (edge_kj [P], edge_ji [P]) int32
    n_graphs: int = 1

    def to(self, device) -> GraphBatch:
        tri = None if self.triplets is None else tuple(
            as_tensor(t, device) for t in self.triplets)
        return GraphBatch(
            as_tensor(self.node_feat, device), as_tensor(self.edge_src, device),
            as_tensor(self.edge_dst, device), as_tensor(self.labels, device),
            as_tensor(self.coords, device), as_tensor(self.graph_id, device),
            tri, self.n_graphs)


def take(x, idx, dim: int = 0):
    """``jnp.take(x, idx, axis=dim)`` for in-range ``idx``: an
    ``index_select``, whose backward is an ``index_add``. The backward of
    advanced indexing (``x[idx]``) sorts the indices and walks each
    repeated one in turn, and the padding of an edge or triplet list
    repeats one index tens of thousands of times (194 ms of a 245 ms
    dimenet step on the card)."""
    return torch.index_select(x, dim, idx)


def aggregate(messages, dst, n_nodes: int, op: str = "sum"):
    """Scatter-aggregate messages [E, F] to nodes by dst (sentinel =
    n_nodes)."""
    if op == "sum":
        out = segment_sum(messages, dst, n_nodes + 1)
    elif op == "mean":
        s = segment_sum(messages, dst, n_nodes + 1)
        cnt = segment_sum(messages.new_ones((messages.shape[0], 1)), dst,
                          n_nodes + 1)
        out = s / torch.clamp_min(cnt, 1.0)
    elif op == "max":
        out = segment_max(messages, dst, n_nodes + 1)
        out = torch.where(torch.isneginf(out), 0.0, out)
    else:
        raise ValueError(op)
    return out[:n_nodes]


class MLP2(nn.Module):
    """Two dense layers with biases and a SiLU between them (``mlp2_def``:
    ``l1`` [d_in -> d_hidden], ``l2`` [d_hidden -> d_out])."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.l1 = Dense(d_in, d_hidden, bias=True, device=device, gen=gen)
        self.l2 = Dense(d_hidden, d_out, bias=True, device=device, gen=gen)

    def forward(self, x):
        return self.l2(F.silu(self.l1(x)))


def radial_basis(dist, n_radial: int, cutoff: float = 5.0):
    """DimeNet-style sine radial basis: sin(n pi d / c) / d."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=dist.device)
    d = torch.clamp_min(dist[..., None], 1e-6)
    return torch.sin(n * math.pi * d / cutoff) / d * math.sqrt(2.0 / cutoff)


def _legendre_all(ct, l_max: int):
    """Associated Legendre P_l^m(ct) for 0<=m<=l<=l_max via stable
    recurrences. Returns list P[l][m] of tensors shaped like ct."""
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    P = [[None] * (l_max + 1) for _ in range(l_max + 1)]
    P[0][0] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        P[m][m] = -(2 * m - 1) * st * P[m - 1][m - 1]
    for m in range(l_max):
        P[m + 1][m] = (2 * m + 1) * ct * P[m][m]
    for m in range(l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[l][m] = ((2 * l - 1) * ct * P[l - 1][m]
                       - (l + m - 1) * P[l - 2][m]) / (l - m)
    return P


def real_spherical_harmonics(vec, l_max: int):
    """Real SH Y_lm of unit-normalized vec [..., 3] up to l_max.
    Returns [..., (l_max+1)^2] ordered (l, m) with m in [-l..l]."""
    v = vec / torch.clamp_min(
        torch.linalg.vector_norm(vec, dim=-1, keepdim=True), 1e-9)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ct = z
    phi = torch.atan2(y, x)
    P = _legendre_all(ct, l_max)
    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                out.append(norm * P[l][0])
            elif m > 0:
                out.append(math.sqrt(2.0) * norm * P[l][am]
                           * torch.cos(am * phi))
            else:
                out.append(math.sqrt(2.0) * norm * P[l][am]
                           * torch.sin(am * phi))
    return torch.stack(out, dim=-1)


def node_or_graph_loss(out, gb: GraphBatch):
    """Shared head: int labels -> per-node classification; float labels ->
    per-graph pooled regression (molecule shape)."""
    if not gb.labels.dtype.is_floating_point:
        return softmax_xent(out, gb.labels), out
    gid = gb.graph_id if gb.graph_id is not None else torch.zeros(
        out.shape[0], dtype=torch.int32, device=out.device)
    pred = segment_sum(out, gid, gb.n_graphs)
    tgt = gb.labels.float().reshape(pred.shape)
    return torch.mean((pred - tgt) ** 2), pred


def sh_degree_index(l_max: int):
    """Per-component degree l and order m arrays of length (l_max+1)^2."""
    ls, ms = [], []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            ls.append(l)
            ms.append(m)
    return np.array(ls, np.int32), np.array(ms, np.int32)
