"""The port's 2D-grid distributed engine (``core.dist``) on gloo ranks.

Each grid shape is one spawn of CPU ranks (``_torch_grid.run_grid``)
that runs every case of that shape; the grid's results must be identical
on every rank (the O(n) state is replicated) and, bit for bit (mates,
duals, AWAC iterations, ``dropped == 0``), equal to:

  - the port's batched engine (``core.batch``) in this process, and
  - JAX's shard_map engine (``repro.core.dist._DistBatchedAWPM``), run on
    8 fake CPU devices in one reference child, beside the spawns.

Shapes and backends follow the JAX suite: 1x1 with "fused", "torch" and
"cuda" (its plain version on the CPU; JAX "xla" and "pallas"), 2x2 with
"fused" and "reference", 2x4 and 4x2 with "fused". The 2x2 grid also
runs the degenerate blocks, a batch of mixed convergence speeds, the MoE
route, the exchange audit under injected faults and the refusals. The
options, ``plan()``/``Matcher`` and the 1x1 grid run in this process.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_grid import run_grid, same  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    ProblemSpec,
    SolveOptions,
    batch,
    dist,
    graph,
    make_grid,
    plan,
    single,
    solve,
)
from repro_torch.core.convert import result_to_numpy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

STATE = ("mate_row", "mate_col", "u", "v")
#: name -> (grid shape, the port's backends)
SHAPES = {"1x1": ((1, 1), ("fused", "torch", "cuda")),
          "2x2": ((2, 2), ("fused", "reference")),
          "2x4": ((2, 4), ("fused",)),
          "4x2": ((4, 2), ("fused",))}
#: the JAX engine's names of the port's backends
JAX_BACKEND = {"fused": "fused", "reference": "reference", "torch": "xla",
               "cuda": "pallas"}


def _stack(gs):
    return tuple(x.numpy() for x in batch.stack_graphs(gs, device="cpu"))


def _cases():
    """name -> (row, col, val, n) batches, every shape runs them."""
    n = 32
    suite = [graph.generate(n, avg_degree=4.0 + (i % 3), kind=k, seed=s)
             for i, (k, s) in enumerate([("uniform", 0), ("antigreedy", 7),
                                         ("circuit", 2), ("banded", 3)])]
    wide = [graph.generate(48, avg_degree=5.0, kind=k, seed=s)
            for k, s in (("powerlaw", 5), ("antigreedy", 11),
                         ("uniform", 12))]
    return {"suite": (*_stack(suite), n), "wide": (*_stack(wide), 48)}


def _degenerate():
    """The 2x2 grid's corner cases: n = 1 (three ranks own only padding),
    an instance whose off-diagonal blocks are empty, all weights tied."""
    out = {}
    g1 = graph.from_coo(np.array([0]), np.array([0]),
                        np.array([0.7], np.float32), 1)
    out["n1"] = (*_stack([g1, g1]), 1)
    n = 16
    rows = list(range(n)) + list(range(8)) + list(range(8, 16))
    cols = list(range(n)) + [(i + 1) % 8 for i in range(8)] \
        + [8 + (i + 1) % 8 for i in range(8)]
    vals = np.random.default_rng(0).uniform(0.1, 1.0, len(rows))
    diag = graph.from_coo(np.array(rows, np.int32), np.array(cols, np.int32),
                          vals.astype(np.float32), n)
    normal = graph.generate(n, avg_degree=4.0, kind="uniform", seed=1)
    out["empty_block"] = (*_stack([diag, normal]), n)
    gs = []
    for seed in (0, 1):
        g0 = graph.generate(n, avg_degree=4.0, kind="uniform", seed=seed,
                            normalize=False)
        real = g0.row < n
        gs.append(graph.from_coo(g0.row[real], g0.col[real],
                                 np.full(int(real.sum()), 0.5, np.float32),
                                 n))
    out["all_ties"] = (*_stack(gs), n)
    return out


def _mixed():
    """Two instances entering AWAC from given states: a chain of
    overlapping heavy 4-cycles from the diagonal matching (about n/2
    rounds) beside a circuit instance at its MCM state (1 or 2)."""
    n = 40
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i), cols.append(i), vals.append(0.1)
    for i in range(n - 1):
        w = 0.5 + 0.4 * i / n
        rows += [i, i + 1]
        cols += [i + 1, i]
        vals += [w, w]
    slow = graph.from_coo(np.array(rows, np.int32), np.array(cols, np.int32),
                          np.array(vals, np.float32), n)
    fast = graph.generate(n, avg_degree=3.0, kind="circuit", seed=2)
    row, col, val = batch.stack_graphs([slow, fast], device="cpu")
    ii = torch.arange(n, dtype=torch.int32)
    st_slow = single.state_from_mates(row[0], col[0], val[0], n, ii, ii)
    st0 = single.greedy_maximal(row[1], col[1], val[1], n)
    st_fast = single.mcm(row[1], col[1], val[1], n, st0.mate_row,
                         st0.mate_col)
    state = tuple(torch.stack([a, b]).numpy()
                  for a, b in zip(st_slow, st_fast))
    return row.numpy(), col.numpy(), val.numpy(), n, state


CASES = _cases()
DEGENERATE = _degenerate()
MIXED = _mixed()
MOE_LOGITS = np.random.default_rng(0).standard_normal((2, 8, 4)).astype(
    np.float32)  # G 2, T 8, E 4: capacity 2 per round
MOE_K, MOE_CAP = 2, 2


def _arrays(case):
    row, col, val, n = case
    return dict(row=row, col=col, val=val, n=n)


def _jobs(shape_name):
    _, backends = SHAPES[shape_name]
    jobs = [(f"{c}__{bk}", "driver", dict(_arrays(CASES[c]), backend=bk))
            for c in CASES for bk in backends]
    suite = _arrays(CASES["suite"])
    jobs += [("suite__packed", "driver", dict(suite, packed=True)),
             ("api", "solve", suite),
             ("check", "solve", dict(suite, exchange_check=True,
                                     packed=True)),
             ("tap_weight", "solve", dict(suite, exchange_check=True,
                                          tap="corrupt_weight"))]
    if shape_name == "1x1":
        jobs.append(("api_cuda", "solve", dict(suite, backend="cuda")))
    if shape_name == "2x2":
        jobs += [(f"degenerate__{c}", "driver", _arrays(case))
                 for c, case in DEGENERATE.items()]
        row, col, val, n, state = MIXED
        jobs += [("mixed", "driver", dict(row=row, col=col, val=val, n=n,
                                          state=state)),
                 ("moe", "moe", dict(logits=MOE_LOGITS, k=MOE_K,
                                     cap=MOE_CAP)),
                 ("tap_drop", "solve", dict(suite, exchange_check=True,
                                            tap="drop_one")),
                 ("a2a_drop", "solve", dict(suite, a2a_caps=(2, 2))),
                 ("cap_small", "solve", dict(suite, cap=4))]
    return jobs


REFERENCE = """
import jax.numpy as jnp
from repro.core import dist as D
from repro.core.single import MatchState

for sname, (shape, backends) in SHAPES.items():
    spec = D.GridSpec(D.make_mesh(shape))
    for c in CASES:
        row, col, val = (IN[f"{c}__{k}"] for k in ("row", "col", "val"))
        n = int(IN[c + "__n"])
        for bk in backends:
            jb = JAX_BACKEND[bk]
            st, it, dr = D._DistBatchedAWPM(spec, n, backend=jb).run(
                row, col, val)
            for k, x in zip(STATE + ("iters", "dropped"), (*st, it, dr)):
                OUT[f"{sname}__{c}__{bk}__{k}"] = x

spec = D.GridSpec(D.make_mesh((2, 2)))
state = MatchState(*(jnp.asarray(IN["mixed__" + k]) for k in STATE))
st, it, dr = D._DistBatchedAWPM(spec, int(IN["mixed__n"])).run(
    IN["mixed__row"], IN["mixed__col"], IN["mixed__val"], state=state)
for k, x in zip(STATE + ("iters", "dropped"), (*st, it, dr)):
    OUT["mixed__" + k] = x
"""


def _reference_inputs():
    out = {}
    for c, (row, col, val, n) in CASES.items():
        out.update({f"{c}__row": row, f"{c}__col": col, f"{c}__val": val,
                    f"{c}__n": np.array(n)})
    row, col, val, n, state = MIXED
    out.update({"mixed__row": row, "mixed__col": col, "mixed__val": val,
                "mixed__n": np.array(n)})
    out.update({"mixed__" + k: x for k, x in zip(STATE, state)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every shape's spawn, beside the JAX child: (shape -> per-rank
    results, the JAX results)."""
    base = tmp_path_factory.mktemp("grid")
    header = (f"SHAPES = {SHAPES!r}\nCASES = {list(CASES)!r}\n"
              f"JAX_BACKEND = {JAX_BACKEND!r}\nSTATE = {STATE!r}\n")
    jax_out, failed = {}, []

    def reference():
        try:
            (base / "jax").mkdir()
            jax_out.update(run_reference(header + REFERENCE,
                                         _reference_inputs(), base / "jax",
                                         n_devices=8))
        except Exception as e:  # raised below, in the test's thread
            failed.append(e)

    child = threading.Thread(target=reference)
    child.start()
    try:
        grids = {name: run_grid(*shape, _jobs(name), base / name)
                 for name, (shape, _) in SHAPES.items()}
    finally:
        child.join()
    if failed:
        raise failed[0]
    return grids, jax_out


def _local(case):
    row, col, val, n = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                        else x for x in case)
    st, iters = batch._awpm_batched(row, col, val, n, backend="torch")
    return {**{k: x.numpy() for k, x in zip(STATE, st)},
            "iters": iters.numpy()}


def _assert_state(got, want, what):
    for k in STATE + ("iters",):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
        assert got[k].dtype == want[k].dtype, (what, k)


def _ok(result):
    assert not (isinstance(result, tuple) and result[0] == "raised"), result
    return result


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_rank_holds_the_same_result(runs, shape):
    per_rank = runs[0][shape]
    assert len(per_rank) == SHAPES[shape][0][0] * SHAPES[shape][0][1]
    for r, out in enumerate(per_rank[1:], 1):
        assert same(out, per_rank[0]), f"rank {r} differs from rank 0"


GRID_CASES = [(s, c, bk) for s, (_, bks) in SHAPES.items() for c in CASES
              for bk in bks]


@pytest.mark.parametrize("shape, case, backend", GRID_CASES,
                         ids=["-".join(x) for x in GRID_CASES])
def test_grid_matches_the_batched_engine(runs, shape, case, backend):
    got = _ok(runs[0][shape][0][f"{case}__{backend}"])
    assert got["dropped"] == 0
    _assert_state(got, _local(CASES[case]), f"{shape} {case} {backend}")


@pytest.mark.parametrize("shape, case, backend", GRID_CASES,
                         ids=["-".join(x) for x in GRID_CASES])
def test_grid_matches_jax(runs, shape, case, backend):
    got = _ok(runs[0][shape][0][f"{case}__{backend}"])
    jax = runs[1]
    key = f"{shape}__{case}__{backend}__"
    want = {k: jax[key + k] for k in STATE + ("iters",)}
    _assert_state(got, want, f"{shape} {case} {backend} vs JAX")
    assert got["dropped"] == int(jax[key + "dropped"]) == 0


@pytest.mark.parametrize("shape", list(SHAPES))
def test_packed_exchange_and_solve_on_the_grid(runs, shape):
    out = runs[0][shape][0]
    _assert_state(_ok(out["suite__packed"]), _local(CASES["suite"]),
                  f"{shape} packed")
    p = MatchingProblem(*(torch.from_numpy(x) for x in CASES["suite"][:3]),
                        n=CASES["suite"][3])
    want = result_to_numpy(solve(p))
    for name in ("api", "check"):
        got = _ok(out[name])
        for k, x in want.items():
            if k == "weight":
                np.testing.assert_allclose(got[k], x, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], x, err_msg=name)
        assert got["execution"] == ("fused", "grid-default")
    if shape == "1x1":
        assert out["api_cuda"]["execution"] == ("cuda", "explicit")
        np.testing.assert_array_equal(out["api_cuda"]["mate_row"],
                                      want["mate_row"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_exchange_check_catches_a_corrupted_weight(runs, shape):
    err = runs[0][shape][0]["tap_weight"]
    assert err[:2] == ("raised", "ExchangeIntegrityError"), err
    assert "integrity check failed" in err[2]


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_degenerate_blocks_on_2x2(runs, case):
    got = _ok(runs[0]["2x2"][0][f"degenerate__{case}"])
    assert got["dropped"] == 0
    _assert_state(got, _local(DEGENERATE[case]), case)


def test_mixed_convergence_speeds_within_batch(runs):
    """The early finisher's state stays frozen, bit for bit, on every
    rank while the slow instance keeps exchanging and augmenting."""
    got = _ok(runs[0]["2x2"][0]["mixed"])
    row, col, val, n, state = MIXED
    st, iters = batch.awac_batched(
        *(torch.from_numpy(x) for x in (row, col, val)), n,
        single.MatchState(*(torch.from_numpy(x) for x in state)),
        backend="torch")
    want = {**{k: x.numpy() for k, x in zip(STATE, st)},
            "iters": iters.numpy()}
    _assert_state(got, want, "mixed vs batched")
    jax = runs[1]
    _assert_state(got, {k: jax["mixed__" + k] for k in STATE + ("iters",)},
                  "mixed vs JAX")
    assert got["iters"][0] >= 20 and got["iters"][1] <= 2, got["iters"]
    assert got["dropped"] == 0


def test_moe_route_on_2x2_equals_the_local_route(runs):
    got = _ok(runs[0]["2x2"][0]["moe"])
    want = M.matching_route_batched(torch.from_numpy(MOE_LOGITS), MOE_K,
                                    MOE_CAP)
    for name, a, b in zip(("expert", "slot", "weight"), got, want[:3]):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("job, error, match", [
    ("tap_drop", "ExchangeIntegrityError", "integrity check failed"),
    ("a2a_drop", "ExchangeIntegrityError", "were dropped by the"),
    ("cap_small", "ValueError", "refusing to truncate"),
])
def test_grid_refusals_on_2x2(runs, job, error, match):
    err = runs[0]["2x2"][0][job]
    assert err[:2] == ("raised", error), err
    assert match in err[2]


# --------------------------------------------------------------------------
# in this process: options, make_grid, the 1x1 grid and the Matcher
# --------------------------------------------------------------------------


def _grid_spec(pr, pc):
    """A grid description for option checks, which read only its shape."""
    return dist.GridSpec(pr, pc, 0, 0, None, None, torch.device("cpu"))


@pytest.mark.parametrize("kwargs, match", [
    (dict(backend="bogus"), "unknown backend"),
    (dict(backend="fused"), "requires SolveOptions.grid"),
    (dict(max_iter=-1), "max_iter"),
    (dict(max_iter=1.5), "max_iter"),
    (dict(min_gain=float("nan")), "min_gain"),
    (dict(min_gain=-1.0), "min_gain"),
    (dict(window_steps=0), "window_steps"),
    (dict(window_steps=True), "window_steps"),
    (dict(cap=0), "cap must be"),
    (dict(cap=64), "requires SolveOptions.grid"),
    (dict(a2a_caps=(8, 8)), "requires SolveOptions.grid"),
    (dict(a2a_caps=(8,)), "a2a_caps"),
    (dict(packed=True), "requires SolveOptions.grid"),
    (dict(exchange_check=True), "requires SolveOptions.grid"),
    (dict(grid="nope"), "grid must be"),
    (dict(grid=_grid_spec(1, 1), backend="cuda_persistent"),
     "cannot take part"),
    (dict(grid=_grid_spec(2, 2), backend="torch"), "needs the 1x1 grid"),
    (dict(grid=_grid_spec(2, 2), backend="cuda"), "needs the 1x1 grid"),
    (dict(grid=_grid_spec(1, 1), a2a_caps=(8, 0)), "a2a_caps"),
], ids=lambda x: str(x)[:40])
def test_options_validation_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        SolveOptions(**kwargs)


def test_options_accept_the_grid_knobs():
    o = SolveOptions(grid=_grid_spec(2, 2), cap=np.int64(128),
                     a2a_caps=(np.int32(8), np.int32(16)), packed=True,
                     exchange_check=True, backend="reference")
    assert o.cap == 128 and type(o.cap) is int and o.a2a_caps == (8, 16)
    assert SolveOptions(grid=_grid_spec(2, 2))._dist_backend() == "fused"
    assert SolveOptions(grid=_grid_spec(1, 1), backend="cuda") \
        ._dist_backend() == "cuda"
    with pytest.raises(ValueError, match="unknown dist AWAC backend"):
        dist._make_awpm_dist_batched(_grid_spec(1, 1), 8, 1, 16, (16, 16),
                                     backend="bogus")
    with pytest.raises(ValueError, match="1x1 grid"):
        dist._make_awpm_dist_batched(_grid_spec(2, 2), 8, 1, 16, (16, 16),
                                     backend="torch")


def test_make_grid_needs_a_group_of_its_size():
    with pytest.raises(ValueError, match="grid"):
        make_grid(2, 2, device="cpu")
    with pytest.raises(ValueError, match="bad grid shape"):
        make_grid(0, 1, device="cpu")
    g = make_grid(1, 1, device="cpu")
    assert (g.pr, g.pc, g.a, g.b, g.rank) == (1, 1, 0, 0, 0)
    assert make_grid(1, 1, device="cpu") is g


def _problem():
    gs = [graph.generate(24, avg_degree=4.0, kind=k, seed=70 + i)
          for i, k in enumerate(("uniform", "antigreedy", "banded"))]
    return MatchingProblem.stack(gs, device="cpu"), gs


def _same_result(a, b, what=""):
    for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
        assert torch.equal(getattr(a, k), getattr(b, k)), (what, k)


def test_solve_and_a_single_instance_on_the_1x1_grid():
    grid = make_grid(1, 1, device="cpu")
    p, gs = _problem()
    _same_result(solve(p, SolveOptions(grid=grid)), solve(p), "batch")
    one = MatchingProblem.from_graph(gs[1], device="cpu")
    r = solve(one, SolveOptions(grid=grid, window_steps=1))
    _same_result(r, solve(one), "single")
    assert r.mate_row.shape == (25,) and r.awac_iters.dim() == 0


def test_matcher_plan_time_engine_build_is_reused():
    grid = make_grid(1, 1, device="cpu")
    p, _ = _problem()
    matcher = plan(p, SolveOptions(grid=grid))
    info = dist._make_awpm_dist_batched.cache_info()
    r = matcher(p)
    after = dist._make_awpm_dist_batched.cache_info()
    assert after.misses == info.misses, "the first call rebuilt the engine"
    assert after.hits == info.hits + 1
    _same_result(r, solve(p), "matcher")
    _same_result(matcher(p), r, "second call")
    # an undersized window_steps pin is lifted to the block bound at plan
    # time, so the first call still finds the plan-time engine
    m2 = plan(p, SolveOptions(grid=grid, window_steps=1))
    info2 = dist._make_awpm_dist_batched.cache_info()
    m2(p)
    assert dist._make_awpm_dist_batched.cache_info().misses == info2.misses
    assert "grid 1x1" in repr(m2)


def test_matcher_denser_than_prototype_gives_replan_error():
    """A prototype-planned block capacity has no headroom: a same-spec but
    denser problem fails with re-plan guidance."""
    grid = make_grid(1, 1, device="cpu")
    n, cap = 16, 64
    ii = np.arange(n, dtype=np.int32)
    sparse = MatchingProblem.from_coo(ii, ii, np.full(n, 0.5, np.float32), n,
                                      capacity=cap, device="cpu")
    g = graph.generate(n, avg_degree=3.0, kind="uniform", seed=0)
    m = np.arange(g.capacity) < g.nnz
    dense = MatchingProblem.from_coo(g.row[m], g.col[m], g.val[m], n,
                                     capacity=cap, device="cpu")
    matcher = plan(sparse, SolveOptions(grid=grid))
    assert np.array_equal(matcher(sparse).mate_row[:n].numpy(), ii)
    with pytest.raises(ValueError, match="plan\\(\\) again"):
        matcher(dense)


def test_matcher_grid_rejects_misfits_and_warm_starts_from_its_result():
    """A grid ``Matcher`` rejects a problem off its planned cap and a warm
    start that does not fit the problem; a fitting warm start from its own
    cold result returns that result after one AWAC round."""
    grid = make_grid(1, 1, device="cpu")
    p, _ = _problem()
    matcher = plan(p, SolveOptions(grid=grid))
    wrong = MatchingProblem(row=p.row[:, :-8], col=p.col[:, :-8],
                            val=p.val[:, :-8], n=p.n)
    with pytest.raises(ValueError, match="planned cap"):
        matcher(wrong)
    cold = matcher(p)
    warm = matcher(p, warm_start=cold)  # a fixed-point seed, on the grid
    assert warm.execution.warm_started and not cold.execution.warm_started
    assert (warm.awac_iters == 1).all()
    for k in ("mate_row", "mate_col", "perfect"):
        assert torch.equal(getattr(warm, k), getattr(cold, k)), k
    with pytest.raises(ValueError, match="does not fit the problem"):
        matcher(p, warm_start=(cold.mate_row[:1], cold.mate_col[:1]))
    # planned from a bare spec: the worst-case block bound
    m2 = plan(ProblemSpec(n=p.n, cap=p.cap, batch=p.batch_size),
              SolveOptions(grid=grid))
    assert m2.block_cap == min(p.cap, p.n * p.n)
    _same_result(m2(p), solve(p), "spec-planned")


def test_matcher_local_reuse_and_spec_checks():
    p, gs = _problem()
    matcher = plan(p, SolveOptions(backend="torch"))
    r1 = matcher(p)
    r2 = matcher(MatchingProblem.stack(list(reversed(gs)), device="cpu"))
    _same_result(r1, solve(p, SolveOptions(backend="torch")), "local")
    assert torch.equal(r2.mate_row.flip(0), r1.mate_row)
    with pytest.raises(ValueError, match="does not match the planned spec"):
        matcher(MatchingProblem.from_graph(gs[0], device="cpu"))
    with pytest.raises(TypeError, match="ProblemSpec or a prototype"):
        plan("spec?")
    m2 = plan(ProblemSpec(n=p.n, cap=p.cap, batch=p.batch_size))
    _same_result(m2(p), solve(p), "spec")
    assert "local" in repr(m2)
