"""BERT4Rec (arXiv:1904.06690) serving: a bidirectional transformer over
item sequences whose scoring head is the tied item-embedding product (the
port of the JAX package's ``models/recsys/bert4rec.py``).

``Bert4Rec`` holds the parameters of ``bert4rec_def``: the item table
``items`` [padded_items, d], the positions ``pos`` [seq_len, d], the
blocks (``ln1``, ``q``, ``k``, ``v``, ``o``, ``ln2``, ``ffn``), ``final_ln``
and ``out_bias`` [padded_items], all float32. Its entries keep JAX's order
and dtypes:

  - ``encode``: item rows plus positions, then per block a pre-norm
    bidirectional attention and a pre-norm GELU MLP, then ``final_ln``;
  - the attention has no mask; its scores are ``einsum(q, k) / sqrt(hd)``
    and its softmax runs in float32. It is plain torch as it is plain jnp
    in JAX (no Pallas kernel); ``scaled_dot_product_attention`` is not
    used, as its numerics differ;
  - ``logits_all_items``: float32 ``hidden @ items.T + out_bias``, a
    plain matrix product (``torch.matmul``; TF32 off, as the launcher
    sets it);
  - ``serve_scores``: next-item scores from the last position over the
    whole table, [B, padded_items];
  - ``retrieval_scores``: the last position against a candidate set,
    ``hidden @ items[candidates].T + out_bias[candidates]``, [B, Nc].

The serving entries run under ``torch.no_grad``; the masked-item (Cloze)
loss ``loss_fn`` runs the same trunk (``_encode``, ``_logits``) with
gradients. ``act_sharding.constrain`` is called where the JAX package
calls it (``rec_act``); it returns its input.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.single import resolve_device
from repro_torch.models.act_sharding import constrain
from repro_torch.models.layers import Dense, GeluMLP, LayerNorm, softmax_xent
from repro_torch.models.param import embed_init, generator
from repro_torch.models.recsys.embedding import lookup, table


class Block(nn.Module):
    def __init__(self, cfg, device=None, gen=None):
        super().__init__()
        d = cfg.embed_dim
        self.ln1 = LayerNorm(d, device=device)
        self.q, self.k, self.v, self.o = (
            Dense(d, d, bias=True, device=device, gen=gen) for _ in range(4))
        self.ln2 = LayerNorm(d, device=device)
        self.ffn = GeluMLP(d, cfg.d_ff_mult * d, device=device, gen=gen)

    def attention(self, x, n_heads: int):
        b, s, d = x.shape
        hd = d // n_heads
        q = self.q(x).reshape(b, s, n_heads, hd)
        k = self.k(x).reshape(b, s, n_heads, hd)
        v = self.v(x).reshape(b, s, n_heads, hd)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / (hd ** 0.5)
        p = torch.softmax(sc.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
        return self.o(o)


class Bert4Rec(nn.Module):
    """The parameters of ``bert4rec_def``, drawn from ``seed`` on
    ``device`` (``models.param``; ``None`` means the card, and without one
    the constructor raises), and the serving entries."""

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        device = resolve_device(device)
        gen = generator(seed, device)
        self.items = table(cfg.padded_items, d, device=device, gen=gen)
        self.pos = nn.Parameter(embed_init(
            torch.empty(cfg.seq_len, d, device=device), gen, 0.02))
        self.blocks = nn.ModuleList(Block(cfg, device=device, gen=gen)
                                    for _ in range(cfg.n_blocks))
        self.final_ln = LayerNorm(d, device=device)
        self.out_bias = nn.Parameter(torch.zeros(cfg.padded_items,
                                                 device=device))

    def _encode(self, item_seq):
        x = constrain(lookup(self.items, item_seq), "rec_act")
        x = x + self.pos[None, : x.shape[1]]
        for bp in self.blocks:
            x = constrain(x + bp.attention(bp.ln1(x), self.cfg.n_heads),
                          "rec_act")
            x = constrain(x + bp.ffn(bp.ln2(x)), "rec_act")
        return self.final_ln(x)

    def _logits(self, hidden):
        return hidden.float() @ self.items.float().T + self.out_bias

    @torch.no_grad()
    def encode(self, item_seq):
        """item_seq [B, S] integer -> hidden [B, S, d]."""
        return self._encode(item_seq)

    @torch.no_grad()
    def logits_all_items(self, hidden):
        """Tied-embedding scores over the whole item table, float32."""
        return self._logits(hidden)

    @torch.no_grad()
    def serve_scores(self, item_seq):
        """Next-item scores from the last position: [B, padded_items]."""
        h = self.encode(item_seq)
        return self.logits_all_items(h[:, -1:])[:, 0]

    @torch.no_grad()
    def retrieval_scores(self, item_seq, candidates):
        """The last position of each sequence against the candidate items
        [Nc] (one batched product, never a loop): [B, Nc]."""
        h = self.encode(item_seq)[:, -1]  # [B, d]
        cand = lookup(self.items, candidates)  # [Nc, d]
        return h.float() @ cand.float().T + self.out_bias[candidates]


def loss_fn(params: Bert4Rec, batch, cfg):
    """The masked-item (Cloze) objective: (xent, {"xent"}). ``batch`` holds
    ``item_seq``, ``labels`` and ``mask`` [B, S] (1 at masked positions),
    as tensors on the model's device."""
    h = params._encode(batch["item_seq"])
    loss = softmax_xent(params._logits(h), batch["labels"], batch["mask"])
    return loss, {"xent": loss}
