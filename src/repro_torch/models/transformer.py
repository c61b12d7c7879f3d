"""Decoder-only LM (Qwen2 and DeepSeek families): GQA + RoPE + SwiGLU,
with MoE layers, the serving entry points ``forward``, ``prefill`` and
``decode_step``, and the training loss ``loss_fn`` (the port of the JAX
package's ``models/transformer.py``).

The JAX package stacks each parameter along a leading layer axis and runs
the layers under ``lax.scan``, and pins activation shardings with
``constrain`` (``act_sharding.py``). Those are compilation and sharding
devices with no role on one eager device, so they are not ported: here
the layers are ``ModuleList``s run by a Python loop. Its ``jax.checkpoint``
of each layer (``cfg.remat``) is ``torch.utils.checkpoint`` of each block
in the loss, which recomputes the block in backward; the serving entries
run under ``torch.no_grad`` and keep nothing to recompute. The layer
groups and the cache keys are JAX's: a dense model has ``blocks``; an MoE
model has ``dense_blocks`` (its ``first_dense`` leading dense layers, if
any) and ``moe_blocks``. Each cache group keeps the JAX layout, (k, v)
each [L, B, S, Hkv, D].
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.single import resolve_device
from repro_torch.models.attention import (
    Attention,
    decode_attention,
    self_attention,
)
from repro_torch.models.layers import MLP, Dense, RMSNorm, rmsnorm, softmax_xent
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.param import embed_init, generator


class Block(nn.Module):
    """Attention and an FFN: an MoE layer (``moe_layer``) or a SwiGLU MLP
    of width ``d_ff`` (``cfg.d_ff`` by default)."""

    def __init__(self, cfg, moe_layer: bool = False, d_ff: int | None = None,
                 device=None, gen=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device, gen=gen)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.moe_layer = moe_layer
        self.ffn = (MoE(cfg, cfg.moe, device=device, gen=gen) if moe_layer
                    else MLP(cfg.d_model, d_ff or cfg.d_ff, device=device,
                             gen=gen))


class LM(nn.Module):
    """The parameters of ``lm_def``: ``embed`` [V, d], the block groups
    (``blocks``, or ``dense_blocks`` and ``moe_blocks``), ``final_norm``
    and, without tied embeddings, ``lm_head``. All float32, drawn from
    ``seed`` on ``device`` (``models.param``): ``None`` means the card,
    and without one the constructor raises (``device="cpu"`` builds on
    the CPU)."""

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        gen = generator(seed, device)
        self.embed = nn.Parameter(embed_init(
            torch.empty(cfg.vocab, cfg.d_model, device=device), gen, 0.02))
        md = cfg.moe
        if md is None:
            self.blocks = nn.ModuleList(Block(cfg, device=device, gen=gen)
                                        for _ in range(cfg.n_layers))
        else:
            if md.first_dense:
                self.dense_blocks = nn.ModuleList(
                    Block(cfg, d_ff=md.d_ff_dense or cfg.d_ff, device=device,
                          gen=gen) for _ in range(md.first_dense))
            self.moe_blocks = nn.ModuleList(
                Block(cfg, moe_layer=True, device=device, gen=gen)
                for _ in range(cfg.n_layers - md.first_dense))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab, device=device, gen=gen))


def _head(params: LM, x, cfg):
    """Logits in float32: the tied head is a float32 product with the
    embedding table, as in the JAX package."""
    x = rmsnorm(params.final_norm.scale, x)
    if cfg.tie_embeddings:
        return x.float() @ params.embed.float().T
    return params.lm_head(x).float()


def _block_groups(params: LM, cfg):
    """[(cache key, blocks)] in the order the layers run."""
    if cfg.moe is None:
        return [("blocks", params.blocks)]
    groups = [("dense_blocks", params.dense_blocks)] \
        if cfg.moe.first_dense else []
    return groups + [("moe_blocks", params.moe_blocks)]


def _ffn(bp: Block, x, cfg):
    """(the block's FFN of x, its aux loss or None)."""
    if bp.moe_layer:
        return moe_apply(bp.ffn, x, cfg, cfg.moe)
    return bp.ffn(x), None


def _block(bp: Block, x, positions, cfg):
    """One block: (x after it, its aux loss or None, its (k, v))."""
    h, kv = self_attention(bp.attn, bp.ln1(x), positions, cfg)
    x = x + h
    f, a = _ffn(bp, bp.ln2(x), cfg)
    return x + f, a, kv


def _block_remat(bp: Block, x, positions, cfg):
    """One block under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in backward. Returns (x after
    it, its aux loss or None)."""
    def run(x):
        y, a, _ = _block(bp, x, positions, cfg)
        return y, (torch.zeros((), device=x.device) if a is None else a)

    y, a = checkpoint(run, x, use_reentrant=False)
    return y, (a if bp.moe_layer else None)


def _trunk(params: LM, tokens, cfg, collect_cache: bool,
           remat: bool = False):
    """Embedding and blocks: (hidden [B, S, d], summed aux loss, cache or
    None). ``remat`` checkpoints each block (training)."""
    dtype = getattr(torch, cfg.dtype)
    b, s = tokens.shape
    x = params.embed[tokens].to(dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    aux = torch.zeros((), device=x.device)
    cache = {}
    for name, blocks in _block_groups(params, cfg):
        group_aux = torch.zeros((), device=x.device)
        ks, vs = [], []
        for bp in blocks:
            if remat:
                x, a = _block_remat(bp, x, positions, cfg)
            else:
                x, a, (k, v) = _block(bp, x, positions, cfg)
            if a is not None:
                group_aux = group_aux + a
            if collect_cache:
                ks.append(k)
                vs.append(v)
        aux = aux + group_aux
        if collect_cache:
            cache[name] = (torch.stack(ks), torch.stack(vs))
    return x, aux, (cache if collect_cache else None)


@torch.no_grad()
def forward(params: LM, tokens, cfg, collect_cache: bool = False):
    """tokens [B, S] -> (logits [B, S, V] float32, aux_loss, cache dict or
    None). The aux loss is the sum over the MoE layers (0.0 for a dense
    model and for the AWPM router)."""
    x, aux, cache = _trunk(params, tokens, cfg, collect_cache)
    return _head(params, x, cfg), aux, cache


def loss_fn(params: LM, batch, cfg):
    """The training loss: (xent + aux, {"xent", "aux"}). ``batch`` holds
    ``tokens`` and ``labels`` [B, S] and optionally ``mask`` [B, S], as
    tensors on the model's device. Runs with gradients; ``cfg.remat``
    checkpoints each block and ``cfg.loss_chunks > 1`` takes the
    sequence-chunked cross-entropy."""
    if cfg.loss_chunks > 1:
        return _chunked_loss_fn(params, batch, cfg)
    x, aux, _ = _trunk(params, batch["tokens"], cfg, False, remat=cfg.remat)
    loss = softmax_xent(_head(params, x, cfg), batch["labels"],
                        batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}


def _chunked_loss_fn(params: LM, batch, cfg):
    """Sequence-chunked cross-entropy: the full [B, S, V] float32 logits
    are never held. Each of ``cfg.loss_chunks`` S-chunks computes its
    logits and reduces them to (nll sum, count) under
    ``torch.utils.checkpoint``, so backward recomputes that chunk's logits
    alone, as JAX's ``jax.checkpoint`` chunk does."""
    x, aux, _ = _trunk(params, batch["tokens"], cfg, False, remat=cfg.remat)
    hidden = rmsnorm(params.final_norm.scale, x)
    b, s, _ = hidden.shape
    nc = cfg.loss_chunks
    assert s % nc == 0, (s, nc)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((b, s), device=hidden.device)

    def chunk(h, lab, msk):
        if cfg.tie_embeddings:
            logits = h.float() @ params.embed.float().T
        else:
            logits = params.lm_head(h).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        msk = msk.float()
        return ((lse - ll) * msk).sum(), msk.sum()

    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    w = s // nc
    for i in range(nc):
        sl = slice(i * w, (i + 1) * w)
        t, c = checkpoint(chunk, hidden[:, sl], batch["labels"][:, sl],
                          mask[:, sl], use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    loss = tot / cnt.clamp_min(1.0)
    return loss + aux, {"xent": loss, "aux": aux}


@torch.no_grad()
def prefill(params: LM, tokens, cfg):
    """Returns (last-position logits [B, V] float32, cache). The head is
    applied to the last position only: the JAX package computes the logits
    of every position and keeps the last row, which is the same row (at
    B = 4, S = 2048 on qwen2-0.5b the full logits take 5 GB)."""
    x, _, cache = _trunk(params, tokens, cfg, collect_cache=True)
    return _head(params, x[:, -1:], cfg)[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cache, token, pos: int, cfg):
    """One decode step. cache: {group: (k, v)}, each [L, B, S_max, Hkv,
    D], written at ``pos`` in place; token [B, 1] int; ``pos`` the current
    length. Returns (logits [B, V] float32, cache)."""
    dtype = getattr(torch, cfg.dtype)
    x = params.embed[token].to(dtype)
    for name, blocks in _block_groups(params, cfg):
        kc, vc = cache[name]
        for i, bp in enumerate(blocks):
            h, _, _ = decode_attention(bp.attn, bp.ln1(x), kc[i], vc[i], pos,
                                       cfg)
            x = x + h
            x = x + _ffn(bp, bp.ln2(x), cfg)[0]
    return _head(params, x, cfg)[:, 0], cache


def cache_shapes(cfg, batch: int, seq: int):
    """{group: ((shape, dtype), (shape, dtype))} of a decode cache."""
    dt = getattr(torch, cfg.dtype)

    def kv(n_layers):
        shp = (n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
        return ((shp, dt), (shp, dt))

    if cfg.moe is None:
        return {"blocks": kv(cfg.n_layers)}
    out = {}
    if cfg.moe.first_dense:
        out["dense_blocks"] = kv(cfg.moe.first_dense)
    out["moe_blocks"] = kv(cfg.n_layers - cfg.moe.first_dense)
    return out
