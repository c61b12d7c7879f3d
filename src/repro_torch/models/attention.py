"""GQA attention with RoPE, QKV bias (Qwen-style) and a KV cache (the port
of the JAX package's ``models/attention.py``).

Prefill attention goes through ``kernels.flash_attention.ops.attention``:
the hand-written CUDA kernel (K5) when ``cfg.attention_impl == "cuda"``,
the plain torch version when it is ``"torch"``. Decode attention, a
1-token query against the [B, S_max, Hkv, D] cache, is plain torch, as it
is plain jnp in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import attention as flash_or_plain
from repro_torch.models.layers import Dense, rope


class Attention(nn.Module):
    """q/k/v/o projections, with biases on q, k and v per ``cfg.qkv_bias``."""

    def __init__(self, cfg, device=None, gen: torch.Generator | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.q = Dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias, device=device,
                       gen=gen)
        self.k = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                       device=device, gen=gen)
        self.v = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                       device=device, gen=gen)
        self.o = Dense(cfg.n_heads * hd, d, device=device, gen=gen)


def _qkv(p: Attention, x, positions, cfg):
    b, s, _ = x.shape
    hd = cfg.hd
    q = p.q(x).reshape(b, s, cfg.n_heads, hd)
    k = p.k(x).reshape(b, s, cfg.n_kv_heads, hd)
    v = p.v(x).reshape(b, s, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(p: Attention, x, positions, cfg):
    """Causal self-attention for prefill. x [B, S, d] -> (out [B, S, d],
    (k, v) each [B, S, Hkv, D])."""
    q, k, v = _qkv(p, x, positions, cfg)
    o = flash_or_plain(q, k, v, causal=True,
                       use_kernel=(cfg.attention_impl == "cuda"))
    b, s, _ = x.shape
    return p.o(o.reshape(b, s, cfg.n_heads * cfg.hd)), (k, v)


def decode_attention(p: Attention, x1, k_cache, v_cache, pos: int, cfg):
    """One decode step. x1 [B, 1, d]; caches [B, S_max, Hkv, D]; ``pos`` the
    current length. Writes this position's k and v into the caches and
    returns (out [B, 1, d], k_cache, v_cache).

    The JAX package returns new caches from ``dynamic_update_slice``; here
    the position is written in place with an index copy, so a decode step
    moves one position of the cache instead of the whole of it."""
    b = x1.shape[0]
    hd = cfg.hd
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _qkv(p, x1, positions, cfg)
    group = cfg.n_heads // cfg.n_kv_heads
    k_cache[:, pos] = k1[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v1[:, 0].to(v_cache.dtype)
    qh = q.reshape(b, cfg.n_kv_heads, group, hd)  # [B, Hkv, G, D]
    scores = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          k_cache.float()) / (hd ** 0.5)
    valid = torch.arange(k_cache.shape[1], device=x1.device) <= pos
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    pexp = torch.exp(scores - m)
    l = pexp.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", pexp,
                     v_cache.float()) / l.clamp_min(1e-30)
    o = o.reshape(b, 1, cfg.n_heads * hd).to(x1.dtype)
    return p.o(o), k_cache, v_cache
