"""The production mesh and the per-family sharding rules (the port of the
JAX package's ``launch/mesh.py``).

A mesh here is data: ``MeshSpec`` holds the axis sizes and names and no
devices. The dry run reads it to shape its cells, pad their sharded
dimensions and reckon what each device holds; nothing is placed on a
device. The rules map a parameter's logical axis names
(``models.param.partition_specs``) to mesh axes, value for value as the
JAX package's rules do.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis sizes (``shape``: name -> size) and their order
    (``axis_names``)."""

    shape: dict
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)


def make_mesh(sizes, axis_names) -> MeshSpec:
    """A ``MeshSpec`` of ``sizes`` over ``axis_names``, in that order."""
    sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
    return MeshSpec(dict(zip(axis_names, sizes)), axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)


def _divisible(dim: int, mesh, axes) -> bool:
    k = math.prod(mesh.shape[a] for a in (axes if isinstance(axes, tuple)
                                          else (axes,)))
    return dim % k == 0


def lm_param_rules(cfg, mesh, variants=()) -> dict:
    """Logical-axis -> mesh-axis rules for LM parameters. TP over "model"
    (heads / mlp / vocab), FSDP over "data" (embed dim), EP over "pod"
    when the expert count divides; the "moe_ep" variant moves EP onto the
    "model" axis (expert_mlp then stays unsharded)."""
    rules = {
        "vocab": "model",
        "mlp": "model",
        "expert_mlp": "model",
        "embed": "data" if cfg.d_model % mesh.shape["data"] == 0 else None,
        "heads": "model" if _divisible(cfg.n_heads * cfg.hd, mesh, "model")
        else None,
        "kv_heads": "model"
        if _divisible(cfg.n_kv_heads * cfg.hd, mesh, "model") else None,
        "experts": None,
    }
    if cfg.moe is not None:
        if any(str(v).startswith("moe_ep") for v in variants) \
                and cfg.moe.n_experts % mesh.shape["model"] == 0:
            rules["experts"] = "model"
            rules["expert_mlp"] = None
        elif "pod" in mesh.axis_names \
                and cfg.moe.n_experts % mesh.shape["pod"] == 0:
            rules["experts"] = "pod"
    return rules


def gnn_param_rules(cfg, mesh) -> dict:
    d = cfg.d_hidden
    ok = d % mesh.shape["model"] == 0
    return {"embed": None, "mlp": "model" if ok else None, "experts": None,
            "vocab": None, "heads": None, "kv_heads": None}


def recsys_param_rules(cfg, mesh) -> dict:
    # tables are row-sharded over "model"; batch uses ALL axes (B >> d)
    return {"vocab": "model", "embed": None, "mlp": None, "heads": None,
            "kv_heads": None, "experts": None}


def matching_rules(mesh) -> dict:
    return {}


def param_rules_for(cfg, mesh) -> dict:
    return {
        "lm": lm_param_rules,
        "gnn": gnn_param_rules,
        "recsys": recsys_param_rules,
    }[cfg.family](cfg, mesh)
