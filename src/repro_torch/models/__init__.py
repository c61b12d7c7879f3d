"""Model facade: config -> parameters for the families the port runs.
The LM family is ported, dense and MoE, and the recsys family (bert4rec
serving); the GNN family comes with a later slice, and ``build_loss`` with
training (ROADMAP.md, Queue 1, item 12)."""
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

