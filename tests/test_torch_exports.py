"""The port's package exports against the JAX package's: every name in the
``__all__`` of a ``src/repro/**/__init__.py`` (read with ``ast``, so no
JAX is imported) is in the ``__all__`` of the port's counterpart
``__init__`` and resolves there, unless :data:`EXCEPTIONS` names it with
its reason. Code written against ``from repro.sparse import
partition_coo_2d`` then ports by renaming the package.
"""
import ast
import importlib

import pytest

pytest.importorskip("torch")

from test_torch_harness import REPO  # noqa: E402

JAX_SRC = REPO / "src" / "repro"
PORT_SRC = REPO / "src" / "repro_torch"

#: the JAX names that the port renamed on purpose: a plain torch version
#: is ``*_plain`` (the port's ``ref`` modules hold the kernels' plain
#: versions, not a reference implementation of another package)
RENAMED = {
    ("kernels.cycle_gain", "cycle_gain_ref"): "cycle_gain_plain",
    ("kernels.embedding_bag", "embedding_bag_ref"): "embedding_bag_plain",
    ("kernels.flash_attention", "attention_ref"): "attention_plain",
    ("kernels.router_swap", "router_swap_ref"): "router_swap_plain",
}

#: the JAX names with no counterpart, and why
EXCEPTIONS = {
    ("sparse", "x64_available"):
        "JAX-only: whether jax_enable_x64 is on; torch has int64 always",
    ("kernels.cycle_gain", "awac_sweep"):
        "JAX's B = 1 slice of awac_sweep_batched with TPU tiling arguments "
        "(te, interpret) that mean nothing here; the single-instance entry "
        "is awac_sweep_winners",
}


def _all_of(path):
    """The names of ``__all__`` in ``path``, or None without one."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def _package(init):
    return ".".join(init.parent.relative_to(JAX_SRC).parts)


JAX_INITS = {_package(p): _all_of(p)
             for p in sorted(JAX_SRC.rglob("__init__.py"))
             if _all_of(p) is not None}
JAX_NAMES = [(pkg, name) for pkg, names in JAX_INITS.items()
             for name in names]


def _port(pkg):
    return importlib.import_module(f"repro_torch.{pkg}")


def test_the_jax_packages_with_all_are_found():
    assert {"core", "data", "experiments", "kernels.cycle_gain",
            "kernels.embedding_bag", "kernels.flash_attention",
            "kernels.router_swap", "serving", "solver",
            "sparse"} == set(JAX_INITS)
    assert len(JAX_NAMES) > 100


@pytest.mark.parametrize("pkg", sorted(JAX_INITS))
def test_counterpart_has_all(pkg):
    init = PORT_SRC.joinpath(*pkg.split("."), "__init__.py")
    assert _all_of(init) is not None, f"repro_torch.{pkg} has no __all__"
    module = _port(pkg)
    assert sorted(module.__all__) == sorted(set(module.__all__))
    for name in module.__all__:
        assert hasattr(module, name), f"repro_torch.{pkg}.{name}"


@pytest.mark.parametrize("pkg, name", JAX_NAMES,
                         ids=[f"{p}.{n}" for p, n in JAX_NAMES])
def test_jax_export_is_exported(pkg, name):
    if (pkg, name) in EXCEPTIONS:
        assert name not in _port(pkg).__all__  # the table would be stale
        return
    ported = RENAMED.get((pkg, name), name)
    module = _port(pkg)
    assert ported in module.__all__, f"repro_torch.{pkg} lacks {ported}"
    got = {}
    exec(f"from repro_torch.{pkg} import {ported} as x", got)
    assert got["x"] is getattr(module, ported)


def test_the_tables_name_real_jax_exports():
    for pkg, name in list(RENAMED) + list(EXCEPTIONS):
        assert name in JAX_INITS[pkg], (pkg, name)
    assert not set(RENAMED) & set(EXCEPTIONS)
    # a renamed name is the port's own plain version, not a new one
    for (pkg, name), ported in RENAMED.items():
        assert name.endswith("_ref") and ported.endswith("_plain")
        assert ported.removesuffix("_plain") == name.removesuffix("_ref")
