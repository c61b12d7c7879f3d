"""Shared harness of the torch port's parity tests, and its own check.

``run_reference`` runs a script against the JAX package in a fresh child
process (``_subproc.run_with_devices``) and exchanges numpy arrays with it
through ``.npz`` files. The child gives ``jax.experimental`` the
``enable_x64`` name that the JAX package imports and that newer jax
releases dropped; the alias lives only in the child, so the JAX suite's
own verdicts in the pytest process do not depend on it. Each test module
runs all its cases in one module-scoped child, which keeps every test far
inside the per-test time budget.

The test modules build their inputs with the port's copy of
``core.graph`` (numpy, seeded), so both sides see identical arrays.
"""
import contextlib
import json
import pathlib
import re
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from _subproc import run_with_devices  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

_PRELUDE = """\
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import numpy as np

"""


def run_reference(body: str, inputs: dict, workdir,
                  n_devices: int = 1) -> dict:
    """Run ``body`` in a child process with the JAX package importable,
    on ``n_devices`` fake CPU devices.

    ``body`` reads the dict ``IN`` (the numpy ``inputs``) and fills the
    dict ``OUT`` with numpy-convertible values; the filled ``OUT`` is
    returned as numpy arrays."""
    workdir = pathlib.Path(workdir)
    src, dst = workdir / "in.npz", workdir / "out.npz"
    np.savez(src, **inputs)
    script = (_PRELUDE + f"IN = dict(np.load({str(src)!r}))\nOUT = {{}}\n"
              + textwrap.dedent(body)
              + f"\nnp.savez({str(dst)!r}, "
              "**{k: np.asarray(v) for k, v in OUT.items()})\n")
    run_with_devices(script, n_devices)
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


#: the port's name of each backend of the JAX package
JAX_BACKENDS = {"reference": "reference", "xla": "torch", "pallas": "cuda",
                "pallas_persistent": "cuda_persistent"}


@contextlib.contextmanager
def same_dispatch_as_jax(workdir):
    """Point the port's ``backend="auto"`` at the counterpart of the JAX
    package's committed dispatch table (``BENCH_dispatch.json``, backends
    renamed by :data:`JAX_BACKENDS`), for a test module that holds the
    port's choices of backend (the resilience chain's first rung, say) to
    JAX's: both sides then resolve "auto" from the same table, whatever
    the port's own measured table says. Spawned ranks inherit it."""
    from repro_torch.kernels import dispatch

    with open(REPO / "BENCH_dispatch.json") as f:
        jax_table = json.load(f)
    entries = {
        key: {"winner": JAX_BACKENDS[e["winner"]],
              "us_per_iter": {JAX_BACKENDS[b]: t
                              for b, t in e["us_per_iter"].items()}}
        for key, e in jax_table["entries"].items()}
    path = dispatch.save_table(entries, {"from": "BENCH_dispatch.json"},
                               pathlib.Path(workdir) / "dispatch.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(dispatch.TABLE_ENV_VAR, str(path))
        dispatch.clear_cache()
        yield path
    dispatch.clear_cache()


def test_harness_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    idx = rng.integers(0, 7, 11).astype(np.int32)
    out = run_reference("""
        import jax.numpy as jnp
        from repro.core import graph
        OUT["twice"] = jnp.asarray(IN["x"]) * 2
        OUT["idx"] = IN["idx"]
        OUT["kinds"] = np.array(len(graph.SUITE_KINDS))
    """, {"x": x, "idx": idx}, tmp_path)
    np.testing.assert_array_equal(out["twice"], x * 2)
    assert out["twice"].dtype == np.float32
    np.testing.assert_array_equal(out["idx"], idx)
    assert int(out["kinds"]) == 5


_BANNED = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:[.\s,]|$)"
    r"|from\s+(?:jax|repro)(?:[.\s]|$))"
    r"|__import__\(\s*['\"](?:jax|repro)\b|import_module\(\s*['\"](?:jax|repro)\b",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    packages = {p.relative_to(REPO / "src" / "repro_torch").parts[0]
                for p in sources[:-1]}
    assert {"core", "kernels", "serving", "runtime", "data", "solver",
            "experiments", "training", "checkpoint", "models", "configs",
            "sparse", "launch", "roofline"} <= packages
    port = REPO / "src" / "repro_torch"
    for module in ("models/gnn/common.py", "roofline/analysis.py",
                   "training/grad_compression.py", "data/suitesparse.py",
                   "runtime/elastic.py", "configs/qwen2_7b.py",
                   "configs/qwen1_5_110b.py", "configs/awpm_paper.py"):
        assert port / module in sources, module
    offenders = []
    for path in sources:
        for m in _BANNED.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, "the port must not import jax or repro:\n" + \
        "\n".join(offenders)


@pytest.mark.parametrize("line, banned", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("from repro.core import single", True),
    ("    import repro", True), ("from repro_torch.core import api", False),
    ("import repro_torch", False), ("x = jaxlike", False),
])
def test_import_pattern(line, banned):
    assert bool(_BANNED.search(line)) == banned


def test_same_dispatch_as_jax_renames_the_committed_table(tmp_path):
    from repro_torch.core.single import resolve_auto
    from repro_torch.kernels import dispatch

    with open(REPO / "BENCH_dispatch.json") as f:
        want = json.load(f)["entries"]["cpu/single_large"]["winner"]
    with same_dispatch_as_jax(tmp_path) as path:
        assert dispatch.table_path() == path
        assert resolve_auto("cpu") == (JAX_BACKENDS[want], "table")
    assert dispatch.table_path() != path
