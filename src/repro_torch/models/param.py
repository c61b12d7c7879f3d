"""Seeded parameter initialisation (the port's counterpart of the JAX
package's ``models/param.py`` initialisers).

Each initialiser fills a tensor in place from a ``torch.Generator``, with
the distributions of the JAX package:

  - ``dense_init``: normal / sqrt(fan_in), fan_in the input width (the
    JAX package's ``scale`` is 1 on this path);
  - ``embed_init``: normal x scale (0.02 for the token table);
  - norm scales are ones and biases zeros (``torch.nn.init``).

The numbers differ from JAX's for the same seed (another generator), and
from one device type to another; the parity tests make their weights with
numpy and carry them across (``models.convert``). ``ParamDef`` and the
logical-axis sharding specs are not ported: the port runs on one device
with no mesh.

An initialiser given no generator leaves its tensor as it is. On the
``meta`` device ``generator`` gives None, so a model is built at full size
with no storage and nothing drawn: the counterpart of JAX's
``abstract_params``, for counting parameters and reading their shapes.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator | None:
    """A generator on ``device`` (so that weights are drawn where they
    live), seeded with ``seed``; None on the ``meta`` device, which draws
    nothing."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


@torch.no_grad()
def dense_init(w: torch.Tensor, gen: torch.Generator | None,
               fan_in: int) -> torch.Tensor:
    if gen is not None:
        w.normal_(generator=gen).div_(math.sqrt(max(fan_in, 1)))
    return w


@torch.no_grad()
def embed_init(w: torch.Tensor, gen: torch.Generator | None,
               scale: float) -> torch.Tensor:
    if gen is not None:
        w.normal_(generator=gen).mul_(scale)
    return w


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
