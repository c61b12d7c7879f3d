"""The port's measured dispatch table for ``backend="auto"``
(``repro_torch.kernels.dispatch``): shape classes, the lookup's fallback
chain and its degradation to None, ``core.single.resolve_backend`` and
``solve()``'s record of how the backend was chosen, each against a table
in the test's directory; the shape classes and lookups against the JAX
package's ``kernels/dispatch.py`` on the same table file; and the
committed table itself."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    SolveOptions,
    graph,
    single,
    solve,
)
from repro_torch.kernels import dispatch as kdispatch  # noqa: E402
from repro_torch.runtime import chaos, resilient  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

SHAPES = [(None, None), (256, None), (257, None), (64, 1), (64, 2),
          (None, 8), (4096, 16), (128, 16)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    kdispatch.clear_cache()
    yield
    kdispatch.clear_cache()


def _fixture_table(path):
    return kdispatch.save_table(
        {"cpu/single_small": {"winner": "torch",
                              "us_per_iter": {"torch": 1.0,
                                              "reference": 2.0}},
         "cpu/batched_large": {"winner": "cuda_persistent",
                               "us_per_iter": {"cuda_persistent": 1.0}}},
        {"note": "unit fixture"}, path)


def _problem(n=24, seed=0):
    return MatchingProblem.from_graph(
        graph.generate(n, avg_degree=4.0, kind="uniform", seed=seed),
        device="cpu")


def test_dispatch_shape_class():
    assert kdispatch.shape_class(None) == "single_large"
    assert kdispatch.shape_class(kdispatch.SMALL_N) == "single_small"
    assert kdispatch.shape_class(kdispatch.SMALL_N + 1) == "single_large"
    assert kdispatch.shape_class(64, batch=1) == "single_small"
    assert kdispatch.shape_class(64, batch=2) == "batched_small"
    assert kdispatch.shape_class(None, batch=8) == "batched_large"


def test_dispatch_lookup_and_fallback_chain(tmp_path):
    p = _fixture_table(tmp_path / "table.json")
    # exact class hits
    assert kdispatch.choose_backend(n=16, platform="cpu", path=p) == "torch"
    assert kdispatch.choose_backend(n=512, batch=4, platform="cpu",
                                    path=p) == "cuda_persistent"
    # same-kind fallback: single_large -> single_small measurement
    assert kdispatch.choose_backend(n=512, platform="cpu", path=p) == "torch"
    # same-kind fallback: batched_small -> batched_large measurement
    assert kdispatch.choose_backend(n=16, batch=4, platform="cpu",
                                    path=p) == "cuda_persistent"
    # unmeasured platform: None, never a guess
    assert kdispatch.choose_backend(n=16, platform="cuda", path=p) is None


def test_dispatch_missing_or_corrupt_table_degrades_to_none(tmp_path):
    missing = tmp_path / "nope.json"
    assert kdispatch.choose_backend(n=16, platform="cpu", path=missing) is None
    corrupt = tmp_path / "bad.json"
    corrupt.write_text("{not json", encoding="utf-8")
    assert kdispatch.choose_backend(n=16, platform="cpu", path=corrupt) is None
    wrong_shape = tmp_path / "wrong.json"
    wrong_shape.write_text(json.dumps({"entries": []}), encoding="utf-8")
    assert kdispatch.choose_backend(n=16, platform="cpu",
                                    path=wrong_shape) is None
    not_a_dict = tmp_path / "list.json"
    not_a_dict.write_text("[1, 2]", encoding="utf-8")
    assert kdispatch.choose_backend(n=16, platform="cpu",
                                    path=not_a_dict) is None
    empty_winner = tmp_path / "empty.json"
    empty_winner.write_text(json.dumps(
        {"entries": {"cpu/single_small": {"winner": "",
                                          "us_per_iter": {}}}}),
        encoding="utf-8")
    assert kdispatch.choose_backend(n=16, platform="cpu",
                                    path=empty_winner) is None


def test_resolve_backend_consults_table_then_heuristic(tmp_path, monkeypatch):
    p = tmp_path / "t.json"
    kdispatch.save_table(
        {"cpu/single_small": {"winner": "reference",
                              "us_per_iter": {"reference": 1.0}}}, {}, p)
    monkeypatch.setenv(kdispatch.TABLE_ENV_VAR, str(p))
    kdispatch.clear_cache()
    assert single.resolve_backend("auto", "cpu", n=16) == "reference"
    assert single.resolve_auto("cpu", n=16) == ("reference", "table")
    # explicit backends pass through untouched, and are checked
    assert single.resolve_backend("cuda_persistent", "cpu") == \
        "cuda_persistent"
    with pytest.raises(ValueError, match="unknown AWAC backend"):
        single.resolve_backend("pallas", "cpu")
    # no entry for the card's platform: the heuristic there
    assert single.resolve_auto("cuda", n=16) == ("cuda_persistent",
                                                 "heuristic")
    # no table -> the labeled heuristic
    monkeypatch.setenv(kdispatch.TABLE_ENV_VAR, str(tmp_path / "absent.json"))
    kdispatch.clear_cache()
    assert single.resolve_backend("auto", "cpu", n=16) == "torch"
    assert single.resolve_auto("cpu", n=16) == ("torch", "heuristic")


def test_solve_records_explicit_execution():
    res = solve(_problem(), SolveOptions(backend="reference"))
    assert (res.execution.backend, res.execution.source) == ("reference",
                                                             "explicit")


def test_solve_records_table_vs_heuristic_source(tmp_path, monkeypatch):
    prob = _problem()
    ref = solve(prob, SolveOptions(backend="reference"))
    p = tmp_path / "t.json"
    kdispatch.save_table(
        {"cpu/single_small": {"winner": "cuda",
                              "us_per_iter": {"cuda": 1.0}},
         "cpu/batched_small": {"winner": "reference",
                               "us_per_iter": {"reference": 1.0}}}, {}, p)
    monkeypatch.setenv(kdispatch.TABLE_ENV_VAR, str(p))
    kdispatch.clear_cache()
    res = solve(prob, SolveOptions(backend="auto"))
    assert (res.execution.backend, res.execution.source) == ("cuda", "table")
    assert res.execution.ran_kernel is False  # the plain version, on the CPU
    assert torch.equal(res.mate_row, ref.mate_row)
    # a batch takes the batched class's winner
    pb = MatchingProblem.stack([graph.generate(24, avg_degree=4.0,
                                               kind="uniform", seed=s)
                                for s in (1, 2)], device="cpu")
    rb = solve(pb)
    assert (rb.execution.backend, rb.execution.source) == ("reference",
                                                           "table")
    monkeypatch.setenv(kdispatch.TABLE_ENV_VAR, str(tmp_path / "absent.json"))
    kdispatch.clear_cache()
    res = solve(prob, SolveOptions(backend="auto"))
    assert (res.execution.backend, res.execution.source) == ("torch",
                                                             "heuristic")
    assert torch.equal(res.mate_row, ref.mate_row)


def test_guard_and_chaos_start_at_the_single_large_winner(tmp_path,
                                                         monkeypatch):
    # the resilience layer resolves "auto" with no instance in hand (n =
    # None), which is the single_large class, as in the JAX package
    p = tmp_path / "t.json"
    kdispatch.save_table(
        {"cpu/single_large": {"winner": "cuda",
                              "us_per_iter": {"cuda": 1.0}},
         "cpu/single_small": {"winner": "reference",
                              "us_per_iter": {"reference": 1.0}}}, {}, p)
    monkeypatch.setenv(kdispatch.TABLE_ENV_VAR, str(p))
    kdispatch.clear_cache()
    rungs = resilient._build_rungs(SolveOptions(), torch.device("cpu"))
    assert [label for label, _ in rungs] == [
        "local cuda", "local torch", "local reference"]
    rr = resilient.resilient_solve(_problem())
    assert rr.report.backend_used == "local cuda"
    assert not rr.report.degraded
    # the chaos matrix's failing rungs start there too
    with chaos.failing_backend("cuda") as hit:
        rr = resilient.resilient_solve(_problem())
    assert hit["n"] >= 1 and rr.report.backend_used == "local torch"


def test_committed_table_routes_auto_to_its_measured_winner():
    table = kdispatch.load_table(kdispatch.DEFAULT_TABLE_PATH)
    assert table is not None, "kernels/dispatch_table.json must be committed"
    meta = table["metadata"]
    for key in ("card", "host_cpu", "torch", "cuda"):
        assert key in meta, key
    classes = ("single_small", "single_large", "batched_small",
               "batched_large")
    for plat in ("cuda", "cpu"):
        for klass in classes:
            entry = table["entries"][f"{plat}/{klass}"]
            us = entry["us_per_iter"]
            # every backend the JAX package has stays measured
            assert set(us) == set(kdispatch.MEASURED_BACKENDS), (plat, klass)
            assert entry["winner"] == min(us, key=us.get), (plat, klass)
    sizes = {"single_small": (128, None), "single_large": (1 << 20, None),
             "batched_small": (128, 16), "batched_large": (1 << 16, 16)}
    for klass, (n, b) in sizes.items():
        want = table["entries"][f"cpu/{klass}"]["winner"]
        assert single.resolve_auto("cpu", n=n, batch=b) == (want, "table")


@pytest.fixture(scope="module")
def jax_lookups(tmp_path_factory):
    work = tmp_path_factory.mktemp("dispatch_ref")
    path = _fixture_table(work / "table.json")
    kdispatch.clear_cache()
    shapes = np.array([[-1 if n is None else n, -1 if b is None else b]
                       for n, b in SHAPES], np.int64)
    return path, run_reference("""
        from repro.kernels import dispatch as kd
        classes, picks = [], []
        for n, b in IN["shapes"].tolist():
            n = None if n < 0 else n
            b = None if b < 0 else b
            classes.append(kd.shape_class(n, b))
            for plat in ("cpu", "tpu"):
                w = kd.choose_backend(n=n, batch=b, platform=plat,
                                      path=str(IN["path"]))
                picks.append("-" if w is None else w)
        OUT["classes"] = np.array(classes)
        OUT["picks"] = np.array(picks)
        OUT["small_n"] = np.array(kd.SMALL_N)
    """, {"shapes": shapes, "path": np.array(str(path))}, work)


def test_classes_and_lookups_equal_jax(jax_lookups):
    path, ref = jax_lookups
    assert int(ref["small_n"]) == kdispatch.SMALL_N
    classes = [kdispatch.shape_class(n, b) for n, b in SHAPES]
    assert classes == ref["classes"].tolist()
    picks = []
    for n, b in SHAPES:
        # JAX's platform "tpu" has no entry in the table, as the port's
        # "cuda" has none: both must answer None
        for plat in ("cpu", "cuda"):
            w = kdispatch.choose_backend(n=n, batch=b, platform=plat,
                                         path=path)
            picks.append("-" if w is None else w)
    assert picks == ref["picks"].tolist()
