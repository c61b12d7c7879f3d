"""GraphCast (arXiv:2212.12794): encoder-processor-decoder mesh GNN (the
port of the JAX package's ``models/gnn/graphcast.py``; parameters as
``graphcast_def`` names them).

Grid nodes (n_vars=227 features) -> encoder over grid2mesh edges -> 16
processor message-passing layers on the (refined icosahedral, here:
coarse synthetic) mesh -> decoder over mesh2grid edges -> per-grid-node
delta of all variables. Node/edge MLPs with residuals and sum
aggregation, as in the paper. Mesh topology is supplied by the data
pipeline (sizes derive from the grid; see ``data/graphs.py``)."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.single import resolve_device
from repro_torch.models.act_sharding import constrain
from repro_torch.models.gnn.common import MLP2, aggregate, as_tensor, take
from repro_torch.models.param import generator


@dataclasses.dataclass
class GraphCastBatch:
    """One GraphCast sample: grid features and target, and the three edge
    lists (grid -> mesh, mesh -> mesh, mesh -> grid). ``n_mesh`` is
    static. ``to`` gives the same batch as tensors on a device."""

    grid_feat: torch.Tensor  # [Ng, n_vars]
    g2m_src: torch.Tensor  # [E1] grid idx
    g2m_dst: torch.Tensor  # [E1] mesh idx
    mesh_src: torch.Tensor  # [Em]
    mesh_dst: torch.Tensor  # [Em]
    m2g_src: torch.Tensor  # [E2] mesh idx
    m2g_dst: torch.Tensor  # [E2] grid idx
    target: torch.Tensor  # [Ng, n_vars]
    n_mesh: int = 4

    def to(self, device) -> GraphCastBatch:
        fields = {f.name: as_tensor(getattr(self, f.name), device)
                  for f in dataclasses.fields(self) if f.name != "n_mesh"}
        return GraphCastBatch(**fields, n_mesh=self.n_mesh)


class GraphCast(nn.Module):
    def __init__(self, cfg, n_vars: int, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator(seed, device)
        d = cfg.d_hidden

        def mlp(d_in, d_out):
            return MLP2(d_in, d, d_out, device=device, gen=gen)

        self.grid_embed = mlp(n_vars, d)
        self.g2m_edge = mlp(d, d)
        self.mesh_node_enc = mlp(d, d)
        self.proc = nn.ModuleList(
            nn.ModuleDict({"edge": mlp(3 * d, d), "node": mlp(2 * d, d)})
            for _ in range(cfg.n_layers))
        self.m2g_edge = mlp(d, d)
        self.grid_dec = mlp(2 * d, n_vars)


def apply(params: GraphCast, gb: GraphCastBatch, cfg):
    ng = gb.grid_feat.shape[0]
    nm = gb.n_mesh
    hg = params.grid_embed(gb.grid_feat)  # [Ng, d]

    # ---- encoder: grid -> mesh
    e1s = torch.clamp(gb.g2m_src, 0, ng - 1)
    msg = params.g2m_edge(take(hg, e1s))
    msg = msg * (gb.g2m_src < ng)[:, None].to(msg.dtype)
    hm = aggregate(msg, torch.where(gb.g2m_src < ng, gb.g2m_dst, nm), nm,
                   "sum")
    hm = params.mesh_node_enc(hm)

    # ---- processor: message passing on the mesh (residual)
    es = torch.clamp(gb.mesh_src, 0, nm - 1)
    ed = torch.clamp(gb.mesh_dst, 0, nm - 1)
    mesh_valid = (gb.mesh_src < nm)[:, None]
    mesh_dst = torch.where(gb.mesh_src < nm, gb.mesh_dst, nm)
    for lp in params.proc:
        hs, hd = take(hm, es), take(hm, ed)
        em = lp["edge"](torch.cat([hs, hd, hs - hd], dim=-1))
        em = em * mesh_valid.to(em.dtype)
        agg = aggregate(em, mesh_dst, nm, "sum")
        hm = constrain(hm + lp["node"](torch.cat([hm, agg], dim=-1)),
                       "nodes")

    # ---- decoder: mesh -> grid
    e2s = torch.clamp(gb.m2g_src, 0, nm - 1)
    dm = params.m2g_edge(take(hm, e2s))
    dm = dm * (gb.m2g_src < nm)[:, None].to(dm.dtype)
    hg2 = aggregate(dm, torch.where(gb.m2g_src < nm, gb.m2g_dst, ng), ng,
                    "sum")
    delta = params.grid_dec(torch.cat([hg, hg2], dim=-1))
    return gb.grid_feat + delta  # next-state prediction


def loss_fn(params: GraphCast, gb: GraphCastBatch, cfg):
    pred = apply(params, gb, cfg)
    return torch.mean((pred - gb.target) ** 2), pred
