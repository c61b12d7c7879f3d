"""Train-step construction and the host-side training loop, with
checkpointing and straggler monitoring (the port of the JAX package's
``training/loop.py``).

``params`` is a model (``nn.Module``) or a mapping name -> tensor; the
loss takes it as it is, and the optimizer updates its tensors in place.
The JAX package jits the step; here it runs eagerly on the parameters'
device.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    parameters,
)


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, aux, {name: gradient}); a parameter the loss does not reach
    gets zeros, as ``jax.grad`` gives it."""
    leaves = parameters(params)
    for p in leaves.values():
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, aux = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), gs)}
    return loss.detach(), aux, grads


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    grad_accum: int = 1):
    """``loss_fn(params, batch) -> (loss, aux)``. Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``grad_accum > 1`` cuts the batch into that many microbatches along
    its leading axis (which it must divide), sums their gradients and
    losses in order and divides by ``grad_accum``, as the JAX package's
    scan does. A graph batch has no such axis and is refused."""

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, _, grads = loss_and_grads(loss_fn, params, batch)
        else:
            if not isinstance(batch, Mapping):
                raise ValueError(f"grad_accum={grad_accum} cuts a batch "
                                 f"along its leading axis; a "
                                 f"{type(batch).__name__} has none to cut")
            loss, grads = None, None
            for i in range(grad_accum):
                micro = {k: x.reshape(grad_accum, -1, *x.shape[1:])[i]
                         for k, x in batch.items()}
                li, _, gi = loss_and_grads(loss_fn, params, micro)
                if grads is None:
                    loss, grads = li, gi
                else:
                    loss = loss + li
                    grads = {k: grads[k] + gi[k] for k in grads}
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss = loss / grad_accum
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def to_device(batch, device):
    """A batch of numpy arrays (or tensors) as tensors on ``device``: a
    dict, or a graph batch dataclass (``GraphBatch``, ``GraphCastBatch``),
    which moves itself with its ``to``."""
    if dataclasses.is_dataclass(batch):
        return batch.to(device)
    return {k: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(device) for k, x in batch.items()}


def _device(params):
    return next(iter(parameters(params).values())).device


def train(params, loss_fn, data_fn, opt_cfg: AdamWConfig, n_steps: int,
          log_every: int = 20, checkpoint_mgr=None, checkpoint_every: int = 0,
          straggler_monitor=None, start_step: int = 0, grad_accum: int = 1):
    """The host loop. ``data_fn(step)`` returns a batch (numpy), moved to
    the parameters' device. Restores the latest checkpoint of
    ``checkpoint_mgr`` first (when ``start_step`` is 0) and saves every
    ``checkpoint_every`` steps. Returns (params, opt_state, history).

    Each step's time ends in a device sync: the loss is read on the host
    (``float``), as the JAX loop reads it."""
    opt_state = init_opt_state(params)
    if checkpoint_mgr is not None and start_step == 0:
        restored = checkpoint_mgr.restore_latest(
            like={"params": parameters(params), "opt": opt_state})
        if restored is not None:
            saved, opt_state, start_step = restored
            with torch.no_grad():
                for name, p in parameters(params).items():
                    p.copy_(saved[name])
            start_step += 1

    device = _device(params)
    step_fn = make_train_step(loss_fn, opt_cfg, grad_accum)
    history = []
    for step in range(start_step, n_steps):
        t0 = time.perf_counter()
        batch = to_device(data_fn(step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if straggler_monitor is not None:
            straggler_monitor.record(step, dt)
        if step % log_every == 0 or step == n_steps - 1:
            history.append({"step": step, "loss": loss, "dt": dt})
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if checkpoint_mgr is not None and checkpoint_every \
                and step and step % checkpoint_every == 0:
            checkpoint_mgr.save(step, parameters(params), opt_state)
    return params, opt_state, history
