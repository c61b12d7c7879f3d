"""Carry the JAX package's LM weights and config across to the port.

``state_dict_from_jax`` turns the JAX parameter tree of ``lm_def`` (numpy
arrays; each block parameter stacked along a leading layer axis, as
``transformer.stack_defs`` makes it) into the state dict of
``transformer.LM``: it unstacks the layers and transposes each dense
weight from JAX's [in, out] to ``nn.Linear``'s [out, in]. It raises on a
leaf it does not consume and on one it lacks. ``config_from_jax`` copies
an ``LMConfig``'s fields and maps ``attention_impl`` "xla" / "pallas" to
"torch" / "cuda".
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, MoECfg

ATTENTION_IMPL = {"xla": "torch", "pallas": "cuda"}

#: JAX leaf of a block (below "blocks/") -> the port's parameter, and
#: whether it is a dense weight to transpose
_BLOCK_LEAVES = {
    "ln1/scale": ("ln1.scale", False),
    "ln2/scale": ("ln2.scale", False),
    **{f"attn/{p}/w": (f"attn.{p}.weight", True) for p in "qkvo"},
    **{f"attn/{p}/b": (f"attn.{p}.bias", False) for p in "qkv"},
    **{f"ffn/{p}/w": (f"ffn.{p}.weight", True)
       for p in ("gate", "up", "down")},
}


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
    for leaf, (name, transpose) in _BLOCK_LEAVES.items():
        key = f"blocks/{leaf}"
        if key not in flat and leaf.endswith("/b") and not cfg.qkv_bias:
            continue
        stacked = take(key)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{key}: {stacked.shape[0]} layers stacked, "
                             f"the config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            w = stacked[i].T if transpose else stacked[i]
            out[f"blocks.{i}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(w))
    out["final_norm.scale"] = torch.from_numpy(take("final_norm/scale").copy())
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = torch.from_numpy(
            np.ascontiguousarray(take("lm_head/w").T))
    left = sorted(set(flat) - used)
    if left:
        raise ValueError(f"JAX leaves the port does not consume: {left}")
    return out
