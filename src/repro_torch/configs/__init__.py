"""Architecture registry: ``--arch <id>`` resolution, over the archs the
port can run. The JAX package's other archs are known by name and raise
``NotImplementedError`` naming the ROADMAP item that ports them."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LMConfig, MoECfg, RecSysConfig

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "bert4rec": "bert4rec",
}

#: archs of the JAX package that the port cannot run yet -> ROADMAP item
_NOT_YET = {
    "qwen2-7b": "Queue 1, item 12d (further dense LMs)",
    "qwen1.5-110b": "Queue 1, item 12d (further dense LMs)",
    "graphsage-reddit": "Queue 1, item 12f (GNNs)",
    "equiformer-v2": "Queue 1, item 12f (GNNs)",
    "dimenet": "Queue 1, item 12f (GNNs)",
    "graphcast": "Queue 1, item 12f (GNNs)",
    "awpm-matching": "Queue 1, item 11 (port benchmarks)",
}


def get_config(arch: str, reduced: bool = False, **kw):
    if arch in _NOT_YET:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP.md, {_NOT_YET[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced(**kw) if reduced else mod.config(**kw)


__all__ = ["LMConfig", "MoECfg", "RecSysConfig", "get_config"]
