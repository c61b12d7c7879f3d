"""Model facade: config -> parameters (``build_defs``) and the training
loss (``build_loss``) for the families the port runs: the LM family, dense
and MoE, and the recsys family (bert4rec). The GNN family comes with a
later slice (ROADMAP.md, Queue 1, item 12f)."""
from __future__ import annotations


def build_defs(cfg, device=None, seed: int = 0):
    """The parameters of ``cfg``'s model, drawn from ``seed`` on
    ``device``: ``None`` means the card, and without one this raises
    (``core.single.resolve_device``; pass ``device="cpu"`` to build on the
    CPU). The JAX package returns parameter definitions here and
    materialises them apart; a torch module is built with its weights."""
    if cfg.family == "lm":
        from repro_torch.models.transformer import LM

        return LM(cfg, device=device, seed=seed)
    if cfg.family == "recsys":
        from repro_torch.models.recsys.bert4rec import Bert4Rec

        return Bert4Rec(cfg, device=device, seed=seed)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                              "(ROADMAP.md, Queue 1, item 12)")


def build_loss(cfg):
    """(model, batch) -> (loss, aux dict), with gradients. The batch is a
    dict of tensors on the model's device, family-specific: ``tokens``,
    ``labels`` and ``mask`` for "lm"; ``item_seq``, ``labels`` and
    ``mask`` for "recsys"."""
    if cfg.family == "lm":
        from repro_torch.models import transformer

        return lambda p, b: transformer.loss_fn(p, b, cfg)
    if cfg.family == "recsys":
        from repro_torch.models.recsys import bert4rec

        return lambda p, b: bert4rec.loss_fn(p, b, cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} has no training loss in the port yet (the "
        f"GNN family: ROADMAP.md, Queue 1, item 12f)")

