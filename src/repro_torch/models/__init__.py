"""Model facade: config -> parameters (``build_defs``) and the training
loss (``build_loss``) for every family the port runs: the LM family,
dense and MoE, the recsys family (bert4rec) and the GNN family
(graphsage, dimenet, equiformer_v2, graphcast)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ShapeSpec

# per-shape output dims for GNN node classification (dataset conventions:
# cora=7, reddit=41, ogbn-products=47, molecule=regression)
GNN_OUT = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
           "molecule": 1}


def gnn_module(kind: str):
    return importlib.import_module(f"repro_torch.models.gnn.{kind}")


def gnn_out_dim(shape_name: str) -> int:
    return GNN_OUT.get(shape_name, 7)


def build_defs(cfg, shape: ShapeSpec | None = None, device=None,
               seed: int = 0):
    """The parameters of ``cfg``'s model, drawn from ``seed`` on
    ``device``: ``None`` means the card, and without one this raises
    (``core.single.resolve_device``; pass ``device="cpu"`` to build on the
    CPU). The JAX package returns parameter definitions here and
    materialises them apart; a torch module is built with its weights.
    LM and recsys models do not depend on ``shape``; a GNN takes its input
    width (``d_feat``) and output size (``GNN_OUT``) from the shape cell,
    and GraphCast its ``n_vars`` from the config."""
    if cfg.family == "lm":
        from repro_torch.models.transformer import LM

        return LM(cfg, device=device, seed=seed)
    if cfg.family == "recsys":
        from repro_torch.models.recsys.bert4rec import Bert4Rec

        return Bert4Rec(cfg, device=device, seed=seed)
    if cfg.family == "gnn":
        if shape is None:
            raise ValueError("a GNN's parameters depend on the shape cell")
        mod = gnn_module(cfg.kind)
        if cfg.kind == "graphcast":
            return mod.GraphCast(cfg, cfg.opt("n_vars", 227), device=device,
                                 seed=seed)
        model = {"graphsage": "GraphSAGE", "dimenet": "DimeNet",
                 "equiformer_v2": "EquiformerV2"}[cfg.kind]
        return getattr(mod, model)(cfg, shape.d("d_feat", 16),
                                   gnn_out_dim(shape.name), device=device,
                                   seed=seed)
    raise ValueError(f"unknown family {cfg.family!r}")


def build_loss(cfg):
    """(model, batch) -> (loss, aux), with gradients. The batch is
    family-specific, on the model's device: a dict of ``tokens``,
    ``labels`` and ``mask`` for "lm"; of ``item_seq``, ``labels`` and
    ``mask`` for "recsys"; a ``GraphBatch`` (GraphCast: a
    ``GraphCastBatch``) for "gnn", whose aux is the model's output."""
    if cfg.family == "lm":
        from repro_torch.models import transformer

        return lambda p, b: transformer.loss_fn(p, b, cfg)
    if cfg.family == "recsys":
        from repro_torch.models.recsys import bert4rec

        return lambda p, b: bert4rec.loss_fn(p, b, cfg)
    if cfg.family == "gnn":
        mod = gnn_module(cfg.kind)
        return lambda p, b: mod.loss_fn(p, b, cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
