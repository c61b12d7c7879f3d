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
numpy and carry them across (``models.convert``). ``ParamDef`` is not
ported: a torch module holds its parameters. Their logical axis names are
the JAX ``ParamDef``'s, kept beside the name map of ``models.convert``
(``logical_axes``); ``partition_specs`` maps them to mesh axes through a
rules dict (``launch.mesh``), as the JAX package's does, for the dry run.

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


def partition_specs(model: torch.nn.Module, rules: dict) -> dict:
    """{parameter name: spec tuple} of ``model`` (a model built by
    ``models.build_defs``, which carries its ``cfg``): each logical axis
    mapped to a mesh axis through ``rules``, None replicated. An axis
    name with no rule raises ``KeyError`` (a typo is caught), as in the
    JAX package."""
    from repro_torch.models.convert import logical_axes

    axes = logical_axes(model.cfg)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(axes):
        raise ValueError(
            f"the axis map and the model disagree: "
            f"{sorted(set(names) ^ set(axes))[:8]}")

    def spec(name):
        entries = []
        for ax in axes[name]:
            if ax is not None and ax not in rules:
                raise KeyError(f"no sharding rule for logical axis {ax!r}")
            entries.append(None if ax is None else rules[ax])
        return tuple(entries)

    return {n: spec(n) for n in names}


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
