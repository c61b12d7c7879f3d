"""GraphSAGE (arXiv:1706.02216): mean aggregator, 2 layers, L2-normalized
hidden states. Works on full graphs and on sampled blocks (minibatch_lg).
The port of the JAX package's ``models/gnn/graphsage.py``; parameters as
``graphsage_def`` names them (``layers.<i>.self``, ``layers.<i>.neigh``,
``out``).

A hidden row that the ReLU zeroes entirely has norm 0: JAX's gradient of
``jnp.linalg.norm`` there is NaN, torch's ``vector_norm`` gives 0. The
port keeps torch's.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.single import resolve_device
from repro_torch.models.act_sharding import constrain
from repro_torch.models.gnn.common import (
    GraphBatch,
    aggregate,
    node_or_graph_loss,
    take,
)
from repro_torch.models.layers import Dense, softmax_xent
from repro_torch.models.param import generator


class GraphSAGE(nn.Module):
    def __init__(self, cfg, d_in: int, n_classes: int, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator(seed, device)
        d = cfg.d_hidden
        layers, din = [], d_in
        for _ in range(cfg.n_layers):
            layers.append(nn.ModuleDict({
                "self": Dense(din, d, bias=True, device=device, gen=gen),
                "neigh": Dense(din, d, device=device, gen=gen),
            }))
            din = d
        self.layers = nn.ModuleList(layers)
        self.out = Dense(d, n_classes, bias=True, device=device, gen=gen)


def apply(params: GraphSAGE, gb: GraphBatch, cfg):
    n = gb.node_feat.shape[0]
    h = gb.node_feat
    src = torch.clamp(gb.edge_src, 0, n - 1)
    valid = (gb.edge_src < n)[:, None]
    for lp in params.layers:
        neigh = aggregate(take(h, src) * valid.to(h.dtype), gb.edge_dst, n,
                          op="mean")
        h = torch.relu(lp["self"](h) + lp["neigh"](neigh))
        h = constrain(h / torch.clamp_min(
            torch.linalg.vector_norm(h, dim=-1, keepdim=True), 1e-6), "nodes")
    return params.out(h)  # [N, n_classes]


def loss_fn(params: GraphSAGE, gb: GraphBatch, cfg, mask=None):
    logits = apply(params, gb, cfg)
    if mask is not None and not gb.labels.dtype.is_floating_point:
        return softmax_xent(logits, gb.labels, mask), logits
    return node_or_graph_loss(logits, gb)
