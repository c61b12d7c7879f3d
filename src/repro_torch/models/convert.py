"""Carry the JAX package's LM weights and config across to the port.

``state_dict_from_jax`` turns the JAX parameter tree of ``lm_def`` (numpy
arrays; each block parameter stacked along a leading layer axis, as
``transformer.stack_defs`` makes it) into the state dict of
``transformer.LM``: it unstacks the layers of each block group
(``blocks``, or ``dense_blocks`` and ``moe_blocks``) and transposes each
dense weight from JAX's [in, out] to ``nn.Linear``'s [out, in]. The
stacked expert weights are [E, in, out] on both sides and are not
transposed. It raises on a leaf it does not consume (``moe_def`` gives the
shared gate no bias, and neither does the port) and on one it lacks.
``config_from_jax`` copies an ``LMConfig``'s fields and maps
``attention_impl`` "xla" / "pallas" to "torch" / "cuda".
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, MoECfg

ATTENTION_IMPL = {"xla": "torch", "pallas": "cuda"}

_FFN = ("gate", "up", "down")


def _block_leaves(cfg, moe_layer: bool) -> dict[str, tuple[str, bool]]:
    """JAX leaf of a block (below its group) -> the port's parameter, and
    whether it is a dense weight to transpose."""
    leaves = {
        "ln1/scale": ("ln1.scale", False),
        "ln2/scale": ("ln2.scale", False),
        **{f"attn/{p}/w": (f"attn.{p}.weight", True) for p in "qkvo"},
    }
    if cfg.qkv_bias:
        leaves.update({f"attn/{p}/b": (f"attn.{p}.bias", False)
                       for p in "qkv"})
    if not moe_layer:
        leaves.update({f"ffn/{p}/w": (f"ffn.{p}.weight", True) for p in _FFN})
        return leaves
    md = cfg.moe
    leaves["ffn/router/w"] = ("ffn.router.weight", True)
    # [E, in, out] in both layouts (``moe.Experts``): no transpose
    leaves.update({f"ffn/experts/{p}": (f"ffn.experts.{p}", False)
                   for p in _FFN})
    if md.n_shared:
        leaves.update({f"ffn/shared/{p}/w": (f"ffn.shared.{p}.weight", True)
                       for p in _FFN})
        if md.shared_gate:
            leaves["ffn/shared_gate/w"] = ("ffn.shared_gate.weight", True)
    return leaves


def _groups(cfg) -> list[tuple[str, int, bool]]:
    """(group, layers, moe_layer) of ``cfg``'s block groups."""
    if cfg.moe is None:
        return [("blocks", cfg.n_layers, False)]
    fd = cfg.moe.first_dense
    return ([("dense_blocks", fd, False)] if fd else []) + [
        ("moe_blocks", cfg.n_layers - fd, True)]


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested mapping of arrays -> {"a/b/c": array}; a flat mapping with
    such keys passes through."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def config_from_jax(fields: Mapping) -> LMConfig:
    """An ``LMConfig`` from the fields of the JAX package's ``LMConfig``
    (``dataclasses.asdict``)."""
    kw = dict(fields)
    kw["attention_impl"] = ATTENTION_IMPL[kw.get("attention_impl", "xla")]
    if kw.get("moe") is not None:
        kw["moe"] = MoECfg(**kw["moe"])
    return LMConfig(**kw)


def state_dict_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """The port's ``LM`` state dict from the JAX parameter tree."""
    flat = flatten(params)
    out, used = {}, set()

    def take(key):
        if key not in flat:
            raise KeyError(f"the JAX tree lacks {key!r}")
        used.add(key)
        return flat[key]

    out["embed"] = torch.from_numpy(take("embed").copy())
    for group, n_layers, moe_layer in _groups(cfg):
        for leaf, (name, transpose) in _block_leaves(cfg, moe_layer).items():
            key = f"{group}/{leaf}"
            stacked = take(key)
            if stacked.shape[0] != n_layers:
                raise ValueError(f"{key}: {stacked.shape[0]} layers stacked, "
                                 f"the config has {n_layers}")
            for i in range(n_layers):
                w = stacked[i].T if transpose else stacked[i]
                out[f"{group}.{i}.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(w))
    out["final_norm.scale"] = torch.from_numpy(take("final_norm/scale").copy())
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = torch.from_numpy(
            np.ascontiguousarray(take("lm_head/w").T))
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"JAX leaves the port does not consume: {left}")
    return out
