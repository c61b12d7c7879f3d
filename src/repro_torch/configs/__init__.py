"""Architecture registry: ``--arch <id>`` resolution, over every arch of
the JAX package's registry: the LM family (dense and MoE), the recsys
and GNN families, and the paper's own matching config."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    GNNConfig,
    LMConfig,
    MatchingConfig,
    MoECfg,
    RecSysConfig,
    ShapeSpec,
    shapes_for,
)

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "graphsage-reddit": "graphsage_reddit",
    "equiformer-v2": "equiformer_v2",
    "dimenet": "dimenet",
    "graphcast": "graphcast",
    "bert4rec": "bert4rec",
    "awpm-matching": "awpm_paper",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "awpm-matching")
ALL_ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False, **kw):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the registry holds "
                       f"{list(ALL_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced(**kw) if reduced else mod.config(**kw)


def list_archs():
    return ALL_ARCHS


__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "GNNConfig", "LMConfig",
           "MatchingConfig", "MoECfg", "RecSysConfig", "ShapeSpec",
           "get_config", "list_archs", "shapes_for"]
