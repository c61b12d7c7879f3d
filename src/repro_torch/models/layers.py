"""Shared neural layers of the LM and recsys paths (the port of the JAX
package's ``models/layers.py``: ``rmsnorm``, ``layernorm``, ``dense``, the
SwiGLU ``mlp``, the GELU ``gelu_mlp`` and ``rope``), with the JAX
package's dtype rules:

  - ``rmsnorm``: ``x * rsqrt(var)`` promotes a bf16 ``x`` to float32 before
    ``* scale``; the result is cast back to ``x``'s dtype;
  - ``layernorm``: JAX's formula written out, in float32: eps 1e-6 inside
    the rsqrt and the population variance (``F.layer_norm`` takes another
    eps);
  - ``gelu_mlp``: ``jax.nn.gelu`` is the tanh approximation by default,
    so the port's is ``F.gelu(x, approximate="tanh")``, not the erf GELU;
  - ``dense``: the float32 weight (and bias) is cast to the activation
    dtype before the product, and the bias is added after it, rounded
    apart as JAX does (``x @ w``, then ``+ b``);
  - ``rope``: the rotation is computed in float32, then cast.

Weights are float32 parameters, cast at each use as in the JAX package.
``Dense`` and ``MLP`` call ``act_sharding.constrain`` where the JAX
package does (``w_fsdp`` on the cast weight, ``mlp_hidden``); it returns
its input.
A dense product is a plain matrix product outside any kernel and goes to
``torch.nn.functional.linear``; ``Dense`` keeps ``nn.Linear``'s layout,
``weight`` [out, in]. ``softmax_xent`` is the training loss: JAX's
masked mean cross-entropy, in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.act_sharding import constrain
from repro_torch.models.param import dense_init


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


class Dense(nn.Module):
    """``y = x @ W^T (+ b)`` with ``W`` [d_out, d_in] float32, cast to
    ``x``'s dtype at use."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, gen: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device))
                     if bias else None)
        dense_init(self.weight, gen, fan_in=d_in)

    def forward(self, x):
        y = F.linear(x, constrain(self.weight.to(x.dtype), "w_fsdp"))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class MLP(nn.Module):
    """SwiGLU MLP (gate/up/down), the Qwen2/LLaMA FFN."""

    def __init__(self, d: int, hidden: int, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.gate = Dense(d, hidden, device=device, gen=gen)
        self.up = Dense(d, hidden, device=device, gen=gen)
        self.down = Dense(hidden, d, device=device, gen=gen)

    def forward(self, x):
        return self.down(constrain(F.silu(self.gate(x)) * self.up(x),
                                   "mlp_hidden"))


def gelu_mlp(up: Dense, down: Dense, x: torch.Tensor) -> torch.Tensor:
    return down(F.gelu(up(x), approximate="tanh"))


class GeluMLP(nn.Module):
    """GELU MLP with biases (BERT-style, used by bert4rec)."""

    def __init__(self, d: int, hidden: int, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.up = Dense(d, hidden, bias=True, device=device, gen=gen)
        self.down = Dense(hidden, d, bias=True, device=device, gen=gen)

    def forward(self, x):
        return gelu_mlp(self.up, self.down, x)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S]. Rotates pairs (d, d + D/2)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions, in float32. logits [..., V],
    labels [...] integer, mask [...] (1 where a position counts)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
