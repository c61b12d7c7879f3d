"""Model-layout attention entry point with kernel dispatch.

Model layout is [B, S, H, D] (sequence-major, as the QKV projections give
it); the kernel takes [B, H, S, D] with any strides, so the heads axis is
swapped in and out as views: no operand is copied, and the kernel writes
its output in the [B, S, H, D] layout of q.

The kernel path is a ``torch.autograd.Function`` whose forward is the
kernel and whose backward recomputes the attention through its plain
version and takes that recomputation's vector-Jacobian product, as the
JAX package's ``custom_vjp`` does with ``attention_ref``. There is no
backward kernel (the JAX package has no Pallas backward either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    attention_plain,
    flash_attention,
)


class FlashAttention(torch.autograd.Function):
    """q [B, H, S, D]; k, v [B, Hkv, Sk, D] -> [B, H, S, D]: the kernel
    forward, the plain version's gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            o = attention_plain(*leaves, causal=ctx.causal)
        grads = torch.autograd.grad(o, leaves, g)
        return (*grads, None)


def attention(q, k, v, *, causal: bool = True, use_kernel: bool = False):
    """q [B, S, H, D]; k, v [B, Sk, Hkv, D] -> [B, S, H, D]."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if use_kernel:
        o = FlashAttention.apply(qt, kt, vt, causal)
    else:
        o = attention_plain(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)
