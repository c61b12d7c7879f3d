"""AdamW + global-norm clipping + cosine schedule (the port of the JAX
package's ``training/optimizer.py``), with its arithmetic written out:

  - the gradients are scaled by ``min(1, clip_norm / max(gn, 1e-9))``,
    ``gn`` their global norm;
  - ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g^2``, bias-
    corrected by ``1 - b^step``;
  - ``p = p - lr * (mh / (sqrt(vh) + eps) + weight_decay * p)``.

``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: they place the
epsilon, the decoupled decay and the clip's epsilon elsewhere. Every
quantity is float32, as the JAX package computes it.

The parameters are a mapping name -> tensor (a model's
``named_parameters()``, or a dict of tensors); the optimizer state holds
``m`` and ``v`` under the same names. The JAX package's
``abstract_opt_state`` and ``opt_specs`` describe the sharded state of
the dry run, which is not ported yet (ROADMAP.md, Queue 1, the dry-run
layer); a state on a shrunk grid is cut by ``runtime.elastic.
reshard_state``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: dict  # name -> tensor, like the parameters
    v: dict


def parameters(params) -> dict:
    """name -> tensor of a model (``named_parameters``) or of a mapping."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> OptState:
    leaves = parameters(params)
    device = next(iter(leaves.values())).device if leaves else None
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    {k: torch.zeros_like(p) for k, p in leaves.items()},
                    {k: torch.zeros_like(p) for k, p in leaves.items()})


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to ``min_lr_ratio``; float32."""
    step = step.to(F32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, step))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    total = torch.zeros((), dtype=F32, device=tensors[0].device)
    for x in tensors:
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: dict, state: OptState):
    """One AdamW step. ``params`` (a model or a mapping of tensors) is
    updated in place, each new value cast to its parameter's dtype;
    ``grads`` maps the same names to gradients. Returns (params, the new
    state, {"grad_norm", "lr"})."""
    leaves = parameters(params)
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gn),
                          cfg.clip_norm / torch.maximum(gn, _f32(1e-9, gn)))
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1 - _f32(cfg.b1, stepf) ** stepf
    b2c = 1 - _f32(cfg.b2, stepf) ** stepf
    new_m, new_v = {}, {}
    for name, p in leaves.items():
        g = grads[name] * scale
        m2 = cfg.b1 * state.m[name] + (1 - cfg.b1) * g
        v2 = cfg.b2 * state.v[name] + (1 - cfg.b2) * torch.square(g)
        mh = m2 / b1c
        vh = v2 / b2c
        p2 = p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                       + cfg.weight_decay * p)
        p.copy_(p2.to(p.dtype))
        new_m[name], new_v[name] = m2, v2
    return params, OptState(step, new_m, new_v), {"grad_norm": gn, "lr": lr}
