"""DimeNet (arXiv:2003.03123): directional message passing with angular
(triplet) features. Structure: RBF edge embedding -> n_blocks interaction
blocks (triplet gather + spherical-radial bilinear layer) -> per-block
output heads summed -> per-node outputs (pooled per graph by the loss).
The port of the JAX package's ``models/gnn/dimenet.py``; parameters as
``dimenet_def`` names them.

Triplets (k->j, j->i) index into the EDGE list (precomputed by the data
pipeline with a fixed capacity; padding index = n_edges).

The bilinear layer ``einsum("pb,bdf,pd->pf", w, bilinear, m_kj)`` is
written as one matrix product ``m_kj @ bilinear`` over [d, b*f] and a sum
over b weighted by ``w``: a plain einsum may contract ``w`` with
``bilinear`` first, a [P, d, f] tensor (4.3 GB at the molecule cell).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.single import resolve_device
from repro_torch.models.act_sharding import constrain
from repro_torch.models.gnn.common import (
    MLP2,
    GraphBatch,
    node_or_graph_loss,
    radial_basis,
    take,
)
from repro_torch.models.layers import Dense
from repro_torch.models.param import dense_init, generator
from repro_torch.sparse.ops import segment_sum


class Block(nn.Module):
    def __init__(self, d: int, n_rad: int, n_sph: int, n_bil: int,
                 n_out: int, device, gen):
        super().__init__()
        self.msg = MLP2(d, d, d, device=device, gen=gen)
        self.rbf_proj = Dense(n_rad, d, device=device, gen=gen)
        self.sbf_proj = Dense(n_sph * n_rad, n_bil, device=device, gen=gen)
        self.bilinear = nn.Parameter(dense_init(
            torch.empty(n_bil, d, d, device=device), gen, fan_in=d))
        self.update = MLP2(d, d, d, device=device, gen=gen)
        self.out = MLP2(d, d, n_out, device=device, gen=gen)


class DimeNet(nn.Module):
    def __init__(self, cfg, d_in: int, n_out: int = 1, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator(seed, device)
        d = cfg.d_hidden
        n_rad = cfg.opt("n_radial", 6)
        n_sph = cfg.opt("n_spherical", 7)
        n_bil = cfg.opt("n_bilinear", 8)
        self.embed_node = Dense(d_in, d, bias=True, device=device, gen=gen)
        self.embed_edge = Dense(2 * d + n_rad, d, bias=True, device=device,
                                gen=gen)
        self.blocks = nn.ModuleList(
            Block(d, n_rad, n_sph, n_bil, n_out, device, gen)
            for _ in range(cfg.n_layers))


def _angles(gb: GraphBatch):
    """cos(angle) at triplets (k->j, j->i) + distances."""
    n = gb.node_feat.shape[0]
    e = gb.edge_src.shape[0]
    src = torch.clamp(gb.edge_src, 0, n - 1)
    dst = torch.clamp(gb.edge_dst, 0, n - 1)
    vec = take(gb.coords, dst) - take(gb.coords, src)
    dist = torch.linalg.vector_norm(vec, dim=-1)
    t_kj, t_ji = gb.triplets
    tk = torch.clamp(t_kj, 0, e - 1)
    tj = torch.clamp(t_ji, 0, e - 1)
    v1 = -take(vec, tk)  # j -> k
    v2 = take(vec, tj)  # j -> i
    cos = torch.sum(v1 * v2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(v1, dim=-1)
        * torch.linalg.vector_norm(v2, dim=-1), 1e-6)
    return dist, cos


def _sbf(cos, dist_kj, n_sph: int, n_rad: int, cutoff: float = 5.0):
    """Spherical-radial basis: Chebyshev-in-angle x sine-in-distance."""
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    sph = torch.cos(ang[:, None] * torch.arange(
        n_sph, dtype=torch.float32, device=cos.device))
    rad = radial_basis(dist_kj, n_rad, cutoff)
    return (sph[:, :, None] * rad[:, None, :]).reshape(cos.shape[0], -1)


def bilinear(w, weight, m_kj):
    """``einsum("pb,bdf,pd->pf", w, weight, m_kj)``: the triplet messages
    [P, d] through each of the ``b`` bilinear maps, mixed by ``w`` [P, b]."""
    n_bil, d, f = weight.shape
    per_map = m_kj @ weight.permute(1, 0, 2).reshape(d, n_bil * f)
    return torch.einsum("pb,pbf->pf", w, per_map.reshape(-1, n_bil, f))


def apply(params: DimeNet, gb: GraphBatch, cfg):
    """Returns per-node outputs [N, n_out]."""
    n = gb.node_feat.shape[0]
    e = gb.edge_src.shape[0]
    n_rad = cfg.opt("n_radial", 6)
    n_sph = cfg.opt("n_spherical", 7)
    src = torch.clamp(gb.edge_src, 0, n - 1)
    dst = torch.clamp(gb.edge_dst, 0, n - 1)
    edge_valid = (gb.edge_src < n)[:, None].to(gb.node_feat.dtype)
    dist, cos = _angles(gb)
    rbf = radial_basis(dist, n_rad)
    h = F.silu(params.embed_node(gb.node_feat))
    m = F.silu(params.embed_edge(torch.cat([take(h, src), take(h, dst), rbf], dim=-1))) \
        * edge_valid

    t_kj, t_ji = gb.triplets
    t_valid = (t_kj < e) & (t_ji < e)
    tk = torch.clamp(t_kj, 0, e - 1)
    tj = torch.clamp(t_ji, 0, e - 1)
    sbf = _sbf(cos, take(dist, tk), n_sph, n_rad)
    sbf = torch.where(t_valid[:, None], sbf, 0.0)
    tri_dst = torch.where(t_valid, tj, e)
    node_dst = torch.where(gb.edge_src < n, dst, n)

    out_sum = None
    for bp in params.blocks:
        # triplet messages: m_kj gathered to each (kj, ji) pair
        m_kj = take(bp.msg(m), tk)
        w = bp.sbf_proj(sbf)  # [P, n_bilinear]
        tri = bilinear(w, bp.bilinear, m_kj)
        agg = segment_sum(torch.where(t_valid[:, None], tri, 0.0), tri_dst,
                          e + 1)[:e]
        m = constrain(m + F.silu(bp.update(m + agg) + bp.rbf_proj(rbf))
                      * edge_valid, "edges")
        # per-block output: edges -> nodes -> graph
        node_out = segment_sum(bp.out(m), node_dst, n + 1)[:n]
        out_sum = node_out if out_sum is None else out_sum + node_out
    return out_sum  # [N, n_out] per-node outputs


def loss_fn(params: DimeNet, gb: GraphBatch, cfg):
    return node_or_graph_loss(apply(params, gb, cfg), gb)
