"""Decoder-only LM (Qwen2 family), dense path: GQA + RoPE + SwiGLU, with
the entry points ``forward``, ``prefill`` and ``decode_step`` (the port of
the JAX package's ``models/transformer.py``).

The JAX package stacks each parameter along a leading layer axis and runs
the layers under ``lax.scan`` with ``jax.checkpoint`` (``remat``), and
pins activation shardings with ``constrain`` (``act_sharding.py``). Those
are compilation and sharding devices with no role on one eager device, so
they are not ported: here the layers are a ``ModuleList`` run by a Python
loop. The KV cache keeps the JAX layout, (k, v) each [L, B, S, Hkv, D].
MoE layers come with the MoE slice (ROADMAP.md, Queue 1, item 12b).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import (
    Attention,
    decode_attention,
    self_attention,
)
from repro_torch.models.layers import MLP, Dense, RMSNorm, rmsnorm
from repro_torch.models.param import embed_init, generator


def _dense_only(cfg):
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP.md, Queue 1, item 12b)")


class Block(nn.Module):
    def __init__(self, cfg, device=None, gen=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device, gen=gen)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, device=device, gen=gen)


class LM(nn.Module):
    """The parameters of ``lm_def``: ``embed`` [V, d], ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head``. All float32,
    drawn from ``seed`` on ``device`` (``models.param``)."""

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        _dense_only(cfg)
        self.cfg = cfg
        gen = generator(seed, device or "cpu")
        self.embed = nn.Parameter(embed_init(
            torch.empty(cfg.vocab, cfg.d_model, device=device), gen, 0.02))
        self.blocks = nn.ModuleList(Block(cfg, device=device, gen=gen)
                                    for _ in range(cfg.n_layers))
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


def _trunk(params: LM, tokens, cfg, collect_cache: bool):
    """Embedding and blocks: (hidden [B, S, d], cache or None)."""
    _dense_only(cfg)
    dtype = getattr(torch, cfg.dtype)
    b, s = tokens.shape
    x = params.embed[tokens].to(dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    ks, vs = [], []
    for bp in params.blocks:
        h, (k, v) = self_attention(bp.attn, bp.ln1(x), positions, cfg)
        x = x + h
        x = x + bp.ffn(bp.ln2(x))
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = {"blocks": (torch.stack(ks), torch.stack(vs))} \
        if collect_cache else None
    return x, cache


@torch.no_grad()
def forward(params: LM, tokens, cfg, collect_cache: bool = False):
    """tokens [B, S] -> (logits [B, S, V] float32, aux_loss, cache dict or
    None). The dense path has no auxiliary loss (0.0)."""
    x, cache = _trunk(params, tokens, cfg, collect_cache)
    return _head(params, x, cfg), torch.zeros((), device=x.device), cache


@torch.no_grad()
def prefill(params: LM, tokens, cfg):
    """Returns (last-position logits [B, V] float32, cache). The head is
    applied to the last position only: the JAX package computes the logits
    of every position and keeps the last row, which is the same row (at
    B = 4, S = 2048 on qwen2-0.5b the full logits take 5 GB)."""
    x, cache = _trunk(params, tokens, cfg, collect_cache=True)
    return _head(params, x[:, -1:], cfg)[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cache, token, pos: int, cfg):
    """One decode step. cache: {"blocks": (k, v)}, each [L, B, S_max, Hkv,
    D], written at ``pos`` in place; token [B, 1] int; ``pos`` the current
    length. Returns (logits [B, V] float32, cache)."""
    _dense_only(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = params.embed[token].to(dtype)
    kc, vc = cache["blocks"]
    for i, bp in enumerate(params.blocks):
        h, _, _ = decode_attention(bp.attn, bp.ln1(x), kc[i], vc[i], pos,
                                   cfg)
        x = x + h
        x = x + bp.ffn(bp.ln2(x))
    return _head(params, x, cfg)[:, 0], cache


def cache_shapes(cfg, batch: int, seq: int):
    """{"blocks": ((shape, dtype), (shape, dtype))} of a decode cache."""
    _dense_only(cfg)
    shp = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"blocks": ((shp, dt), (shp, dt))}
