"""Model-layout attention entry point with kernel dispatch.

Model layout is [B, S, H, D] (sequence-major, as the QKV projections give
it); the kernel takes [B, H, S, D] with any strides, so the heads axis is
swapped in and out as views: no operand is copied, and the kernel writes
its output in the [B, S, H, D] layout of q. The JAX package wraps its
kernel in a ``custom_vjp`` whose backward recomputes through the
reference; that backward is training and comes with the training slice
as a ``torch.autograd.Function``. Until then the kernel path refuses
inputs that require a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    attention_plain,
    flash_attention,
)


def attention(q, k, v, *, causal: bool = True, use_kernel: bool = False):
    """q [B, S, H, D]; k, v [B, Sk, Hkv, D] -> [B, S, H, D]."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if use_kernel:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            raise NotImplementedError(
                "the flash-attention kernel has no backward yet (ROADMAP.md, "
                "Queue 1, item 12c); use attention_impl='torch' to train")
        o = flash_attention(qt, kt, vt, causal=causal)
    else:
        o = attention_plain(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)
