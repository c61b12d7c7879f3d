"""The port's production mesh, sharding rules and parameter partition
specs (``launch/mesh.py``, ``models/param.py::partition_specs``) against
the JAX package's, exactly.

The JAX side runs once in a child process with 512 fake CPU devices (the
multi-pod mesh needs them): the rules of every arch on both meshes, with
the LM variants, and ``partition_specs(build_defs(cfg), rules)`` of every
arch (every GNN shape cell, whose input widths differ). Its specs are
carried to the port's parameter names through ``models/convert.py``'s
name map: a stacked LM leaf loses its leading layer axis, and a weight
that the converter transposes has its spec reversed.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import shapes_for  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import build_defs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.param import partition_specs  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

VARIANTS = ((), ("moe_ep",), ("moe_ep:1024",))

REFERENCE = """
import json

from repro.configs import ALL_ARCHS, get_config
from repro.configs.base import shapes_for
from repro.launch import mesh as M
from repro.models import build_defs
from repro.models.param import partition_specs

VARIANTS = ((), ("moe_ep",), ("moe_ep:1024",))


def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


meshes = {"single": M.make_production_mesh(),
          "multi": M.make_production_mesh(multi_pod=True)}
OUT["meshes"] = json.dumps({k: [dict(m.shape), list(m.axis_names)]
                            for k, m in meshes.items()})
rules, specs, extra = {}, {}, {}
for mk, mesh in meshes.items():
    extra[mk] = [list(M.batch_axes(mesh)), list(M.all_axes(mesh)),
                 M.matching_rules(mesh)]
for arch in ALL_ARCHS:
    cfg = get_config(arch)
    if cfg.family == "matching":
        continue
    for mk, mesh in meshes.items():
        rules[f"{arch}|{mk}"] = M.param_rules_for(cfg, mesh)
        variants = VARIANTS if cfg.family == "lm" else ((),)
        for v in variants:
            if v:
                rules[f"{arch}|{mk}|{','.join(v)}"] = M.lm_param_rules(
                    cfg, mesh, v)
            r = M.lm_param_rules(cfg, mesh, v) if v else rules[f"{arch}|{mk}"]
            shapes = shapes_for(cfg) if cfg.family == "gnn" else [None]
            for shape in shapes:
                defs = build_defs(cfg, shape)
                ps = partition_specs(defs, r)
                key = f"{arch}|{mk}|{','.join(v)}|{shape.name if shape else ''}"
                specs[key] = {p: enc(d) for p, d in flat(ps).items()}
                extra[key] = {p: list(d.shape) for p, d in flat(defs).items()}
try:
    partition_specs(build_defs(get_config("qwen2-0.5b")), {"embed": None})
except KeyError as e:
    OUT["keyerror"] = str(e)
OUT["rules"] = json.dumps(rules)
OUT["specs"] = json.dumps(specs)
OUT["extra"] = json.dumps(extra)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = run_reference(REFERENCE, {}, tmp_path_factory.mktemp("rules"),
                        n_devices=512)
    return {k: json.loads(str(v)) if k != "keyerror" else str(v)
            for k, v in out.items()}


def _meshes():
    return {"single": M.make_production_mesh(),
            "multi": M.make_production_mesh(multi_pod=True)}


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _jax_specs_by_port_name(cfg, jax_specs: dict) -> dict:
    """JAX's specs {path: spec} carried to the port's parameter names
    through the converter's name map."""
    out = {}
    if cfg.family == "lm":
        for key, n_layers, leaf in convert._lm_entries(cfg):
            spec = _spec(jax_specs[key])
            spec = spec[1:] if n_layers else spec  # the stacked layer axis
            spec = spec[::-1] if leaf.transpose else spec
            for i in range(n_layers or 1):
                out[leaf.name.format(i) if n_layers else leaf.name] = spec
        assert len(jax_specs) == sum(1 for _ in convert._lm_entries(cfg))
        return out
    leaves = (convert._bert4rec_leaves(cfg) if cfg.family == "recsys"
              else convert._gnn_leaves(cfg))
    assert sorted(leaves) == sorted(jax_specs)
    for key, leaf in leaves.items():
        spec = _spec(jax_specs[key])
        out[leaf.name] = spec[::-1] if leaf.transpose else spec
    return out


def test_production_meshes_equal_jax(ref):
    for mk, mesh in _meshes().items():
        shape, names = ref["meshes"][mk]
        assert mesh.shape == shape and list(mesh.axis_names) == names
        assert mesh.size == (512 if mk == "multi" else 256)
        bax, allax, match = ref["extra"][mk]
        assert list(M.batch_axes(mesh)) == bax
        assert list(M.all_axes(mesh)) == allax
        assert M.matching_rules(mesh) == match


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a != "awpm-matching"])
def test_param_rules_equal_jax(ref, arch):
    cfg = get_config(arch)
    for mk, mesh in _meshes().items():
        assert M.param_rules_for(cfg, mesh) == ref["rules"][f"{arch}|{mk}"]
        if cfg.family == "lm":
            for v in VARIANTS[1:]:
                assert M.lm_param_rules(cfg, mesh, v) == \
                    ref["rules"][f"{arch}|{mk}|{','.join(v)}"], (mk, v)


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a != "awpm-matching"])
def test_partition_specs_equal_jax_through_the_converter(ref, arch):
    cfg = get_config(arch)
    shapes = shapes_for(cfg) if cfg.family == "gnn" else [None]
    variants = VARIANTS if cfg.family == "lm" else ((),)
    models = {s: build_defs(cfg, s, device="meta") for s in shapes}
    for mk, mesh in _meshes().items():
        for v in variants:
            rules = M.lm_param_rules(cfg, mesh, v) if v \
                else M.param_rules_for(cfg, mesh)
            for shape in shapes:
                key = f"{arch}|{mk}|{','.join(v)}|{shape.name if shape else ''}"
                want = _jax_specs_by_port_name(cfg, ref["specs"][key])
                got = partition_specs(models[shape], rules)
                assert got == want, key


def test_logical_axes_cover_every_parameter_in_its_layout():
    # every axis tuple has the rank of its parameter
    for arch in ("qwen2-moe-a2.7b", "deepseek-moe-16b", "bert4rec",
                 "dimenet", "equiformer-v2"):
        cfg = get_config(arch)
        shape = shapes_for(cfg)[0] if cfg.family == "gnn" else None
        model = build_defs(cfg, shape, device="meta")
        axes = convert.logical_axes(cfg)
        for name, p in model.named_parameters():
            assert len(axes[name]) == p.dim(), name


def test_an_unknown_axis_raises_keyerror_as_in_jax(ref):
    model = build_defs(get_config("qwen2-0.5b"), device="meta")
    with pytest.raises(KeyError, match="no sharding rule"):
        partition_specs(model, {"embed": None})
    assert "no sharding rule" in ref["keyerror"]


def test_divisible_and_the_moe_ep_variant():
    mesh = M.make_production_mesh(multi_pod=True)
    assert M._divisible(32, mesh, "model")
    assert not M._divisible(24, mesh, ("pod", "data"))
    cfg = get_config("qwen2-moe-a2.7b")  # 60 experts: EP over pod only
    assert M.lm_param_rules(cfg, mesh)["experts"] == "pod"
    assert M.lm_param_rules(cfg, mesh, ("moe_ep",))["experts"] == "pod"
    cfg = get_config("deepseek-moe-16b")  # 64 experts divide "model"
    r = M.lm_param_rules(cfg, mesh, ("moe_ep",))
    assert (r["experts"], r["expert_mlp"]) == ("model", None)
    assert M.make_mesh((1, 1), ("data", "model")).size == 1
    with pytest.raises(ValueError):
        M.make_mesh((1,), ("data", "model"))
    assert np.prod(list(mesh.shape.values())) == mesh.size
