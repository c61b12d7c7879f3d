"""The port's ``solve()`` facade end to end against JAX ``solve()``, its
device handling on the CPU, its input policies, the 1x1 grid, and warm
start from an earlier result (``tests/test_torch_warm.py`` holds warm
start against JAX).

``weight`` is compared with rtol 1e-6: it is ``u[:n].sum()`` in float32,
and torch and XLA add the n terms in different orders. Every other field
(mates, iteration counts, perfect flags, the preflight diagnosis) is
compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    InfeasibleProblemError,
    MatchingProblem,
    PreflightError,
    SolveOptions,
    batch,
    graph,
    make_grid,
    preflight,
    single,
    solve,
)
from repro_torch.core.convert import (  # noqa: E402
    problem_from_numpy,
    result_to_numpy,
    state_from_numpy,
)
from repro_torch.kernels import dispatch as kdispatch  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

FIELDS = ("mate_row", "mate_col", "weight", "awac_iters", "perfect")


def _hall_violation(n, seed):
    g = graph.generate(n, avg_degree=5.0, kind="uniform", seed=seed)
    m = g.nnz
    keep = g.row[:m] >= 2
    return graph.from_coo(np.concatenate([g.row[:m][keep], [0, 1]]),
                          np.concatenate([g.col[:m][keep], [0, 0]]),
                          np.concatenate([g.val[:m][keep], [0.5, 0.7]]), n)


def _dirty(n, seed):
    """A NaN weight and a duplicate coordinate: fatal, repaired by
    ``on_invalid="sanitize"``."""
    g = graph.generate(n, avg_degree=5.0, kind="antigreedy", seed=seed)
    m = g.nnz
    row, col, val = g.row[:m].copy(), g.col[:m].copy(), g.val[:m].copy()
    val[7] = np.nan
    return graph.from_coo(np.append(row, row[20]), np.append(col, col[20]),
                          np.append(val, np.float32(0.99)), n)


def _cases():
    """name -> (row, col, val, n, on_invalid)."""
    cases = {}
    for i, kind in enumerate(graph.SUITE_KINDS):
        g = graph.generate(120, avg_degree=4.0 + i, kind=kind, seed=50 + i)
        cases[kind] = (g.row, g.col, g.val, 120, "raise")
    stacked = MatchingProblem.stack(
        [graph.generate(64, avg_degree=5.0, kind=k, seed=60 + i)
         for i, k in enumerate(graph.SUITE_KINDS)] + [_hall_violation(64, 9)],
        device="cpu")
    cases["batch_degrade"] = (stacked.row.numpy(), stacked.col.numpy(),
                              stacked.val.numpy(), 64, "degrade")
    g = _hall_violation(80, 11)
    cases["infeasible_degrade"] = (g.row, g.col, g.val, 80, "degrade")
    g = graph.generate(80, avg_degree=4.0, kind="powerlaw", seed=12)
    m = g.nnz
    keep = g.col[:m] != 5  # column 5 loses every edge
    g = graph.from_coo(g.row[:m][keep], g.col[:m][keep], g.val[:m][keep], 80)
    cases["empty_col_degrade"] = (g.row, g.col, g.val, 80, "degrade")
    g = _dirty(100, 13)
    cases["dirty_sanitize"] = (g.row, g.col, g.val, 100, "sanitize")
    return cases


CASES = _cases()

REFERENCE = """
from repro.core import MatchingProblem, SolveOptions, preflight, solve

for nm in [str(x) for x in IN["names"]]:
    p = MatchingProblem(row=IN[nm + "__row"], col=IN[nm + "__col"],
                        val=IN[nm + "__val"], n=int(IN[nm + "__n"]))
    r = solve(p, SolveOptions(on_invalid=str(IN[nm + "__policy"])))
    for k in FIELDS:
        OUT[f"{nm}__{k}"] = np.asarray(getattr(r, k))
    issues = [] if r.diagnosis is None else r.diagnosis.issues
    OUT[nm + "__diag"] = np.array(
        [f"{i.kind}:{i.count}:{i.instance}" for i in issues] or [""])
    report = preflight.preflight(p, feasibility=True)
    OUT[nm + "__screen"] = np.array(
        [f"{i.kind}:{i.count}:{i.instance}" for i in report.issues] or [""])
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"names": np.array(list(CASES))}
    for nm, (row, col, val, n, policy) in CASES.items():
        inputs.update({f"{nm}__row": row, f"{nm}__col": col,
                       f"{nm}__val": val, f"{nm}__n": np.array(n),
                       f"{nm}__policy": np.array(policy)})
    return run_reference(f"FIELDS = {FIELDS!r}\n" + REFERENCE, inputs,
                         tmp_path_factory.mktemp("api"))


@pytest.mark.parametrize("backend", ["auto", "reference", "torch", "cuda",
                                     "cuda_persistent"])
@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(ref, name, backend):
    row, col, val, n, policy = CASES[name]
    p = problem_from_numpy(row, col, val, n, device="cpu")
    r = solve(p, SolveOptions(backend=backend, on_invalid=policy))
    got = result_to_numpy(r)
    for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
        np.testing.assert_array_equal(got[k], ref[f"{name}__{k}"],
                                      err_msg=f"{name}: {k}")
    np.testing.assert_allclose(got["weight"], ref[f"{name}__weight"],
                               rtol=1e-6)
    issues = [] if r.diagnosis is None else r.diagnosis.issues
    want = [x for x in ref[f"{name}__diag"].tolist() if x]
    assert [f"{i.kind}:{i.count}:{i.instance}" for i in issues] == want


@pytest.mark.parametrize("name", list(CASES))
def test_preflight_feasibility_screen_matches_jax(ref, name):
    row, col, val, n, _ = CASES[name]
    report = preflight.preflight(problem_from_numpy(row, col, val, n,
                                                    device="cpu"),
                                 feasibility=True)
    want = [x for x in ref[f"{name}__screen"].tolist() if x]
    assert [f"{i.kind}:{i.count}:{i.instance}" for i in report.issues] == want


def test_cases_cover_the_policies(ref):
    assert not ref["infeasible_degrade__perfect"]
    assert ref["batch_degrade__perfect"].tolist() == [True] * 5 + [False]
    assert ref["batch_degrade__awac_iters"][-1] == 0
    assert "empty_col" in ref["empty_col_degrade__diag"][0]
    diag = ref["dirty_sanitize__diag"].tolist()
    assert any(d.startswith("nonfinite_weight") for d in diag)
    assert any(d.startswith("duplicate_edge") for d in diag)
    assert ref["dirty_sanitize__perfect"]
    assert "deficient:1:5" in ref["batch_degrade__screen"].tolist()


def _problem(n=60, device="cpu", seed=0):
    return MatchingProblem.from_graph(
        graph.generate(n, avg_degree=5.0, kind="antigreedy", seed=seed),
        device=device)


def test_cpu_device_handling():
    p = _problem()
    assert p.device.type == "cpu" and p.row.dtype == torch.int32
    r = solve(p)
    # "auto" follows the committed dispatch table's CPU entry for the
    # single_small class, and the heuristic ("torch") without one
    winner = kdispatch.choose_backend(n=p.n, platform="cpu")
    assert (r.execution.backend, r.execution.source) == (
        (winner, "table") if winner is not None else ("torch", "heuristic"))
    kernel = r.execution.backend in ("cuda", "cuda_persistent")
    assert r.execution.device == "cpu"
    assert r.execution.ran_kernel is (False if kernel else None)
    assert r.mate_row.device.type == "cpu" and r.mate_row.shape == (61,)
    r = solve(p, SolveOptions(backend="cuda_persistent"))
    assert r.execution.ran_kernel is False  # the plain version ran
    b = MatchingProblem.stack([_problem(seed=1), _problem(seed=2)],
                              device="cpu")
    assert b.is_batched and b.batch_size == 2 and b.device.type == "cpu"
    assert solve(b).mate_row.shape == (2, 61)


def test_default_device_is_the_card():
    g = graph.generate(40, avg_degree=4.0, kind="uniform", seed=3)
    builders = [
        lambda: MatchingProblem.from_graph(g).row,
        lambda: MatchingProblem.stack([g]).row,
        lambda: problem_from_numpy(g.row, g.col, g.val, g.n).row,
        lambda: batch.stack_graphs([g])[0],
        lambda: batch.empty_mates(2, g.n)[0],
        lambda: single.empty_state(g.n).mate_row,
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_warm_start_from_a_fixed_point_returns_it():
    """Warm start from the earlier result of the same problem returns it
    unchanged, after one AWAC round, locally and on the 1x1 grid."""
    p = _problem()
    prev = solve(p)
    grid = SolveOptions(grid=make_grid(1, 1, device="cpu"))
    for r in (solve(p, warm_start=prev), solve(p, grid, warm_start=prev)):
        assert r.execution.warm_started
        assert int(r.awac_iters) == 1
        for k in ("mate_row", "mate_col", "weight", "perfect"):
            assert torch.equal(getattr(r, k), getattr(prev, k)), k
    assert not prev.execution.warm_started


def test_solve_on_the_1x1_grid():
    grid = make_grid(1, 1, device="cpu")
    p = _problem()
    want = solve(p)
    for backend in ("auto", "fused", "reference", "torch", "cuda"):
        r = solve(p, SolveOptions(grid=grid, backend=backend))
        for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
            assert torch.equal(getattr(r, k), getattr(want, k)), (backend, k)
        assert r.execution.backend == ("fused" if backend == "auto"
                                       else backend)
        assert r.execution.source == ("grid-default" if backend == "auto"
                                      else "explicit")
    with pytest.raises(ValueError, match="GridSpec"):
        SolveOptions(grid=object())


def test_input_policies_raise():
    g = _dirty(50, 1)
    with pytest.raises(PreflightError, match="non-finite"):
        solve(MatchingProblem.from_graph(g, device="cpu"))
    g = _hall_violation(50, 2)
    with pytest.raises(InfeasibleProblemError, match="deficiency 1"):
        solve(MatchingProblem.from_graph(g, device="cpu"))


@pytest.mark.parametrize("kwargs, match", [
    ({"backend": "xla"}, "unknown backend"),
    ({"max_iter": -1}, "max_iter"),
    ({"min_gain": -1e-3}, "min_gain"),
    ({"window_steps": 0}, "window_steps"),
    ({"on_invalid": "ignore"}, "on_invalid"),
])
def test_options_are_validated(kwargs, match):
    with pytest.raises(ValueError, match=match):
        SolveOptions(**kwargs)


def test_problem_is_validated():
    p = _problem()
    with pytest.raises(ValueError, match="shapes differ"):
        MatchingProblem(row=p.row, col=p.col[:-1], val=p.val, n=p.n)
    with pytest.raises(ValueError, match="int32"):
        MatchingProblem(row=p.row.long(), col=p.col, val=p.val, n=p.n)
    with pytest.raises(TypeError, match="torch.Tensor"):
        MatchingProblem(row=p.row.numpy(), col=p.col, val=p.val, n=p.n)


def test_convert_round_trip():
    p = _problem()
    q = problem_from_numpy(p.row.numpy(), p.col.numpy(), p.val.numpy(), p.n,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip((p.row, p.col, p.val), (q.row, q.col, q.val)))
    r = solve(q)
    st = state_from_numpy(r.mate_row.numpy(), r.mate_col.numpy(),
                          np.zeros(p.n + 1), np.zeros(p.n + 1), device="cpu")
    assert st.u.dtype == torch.float32 and torch.equal(st.mate_row, r.mate_row)
    out = result_to_numpy(r)
    assert set(out) == set(FIELDS) and out["mate_row"].dtype == np.int32
    assert dataclasses.replace(r).execution == r.execution
