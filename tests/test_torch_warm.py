"""Warm-start rematching in the port (``core.batch._awpm_batched_from_state``
and its pieces, ``solve(warm_start=)``, ``Matcher(warm_start=)`` and warm
start on a grid) against the JAX package on identical inputs and seeds.

Mates, duals (u, v) and AWAC iteration counts are compared exactly;
``weight`` with rtol 1e-6 (a float32 sum whose order differs between
torch and XLA). The JAX side runs once, in one child process with 4 fake
CPU devices (its shard_map engine takes the 2x2 grid); the port's 2x2
grid is one spawn of gloo ranks (``_torch_grid.run_grid``).

Seeds: the cold result of the same batch (an AWAC fixed point: every pair
kept, no MCM phase, one AWAC round), as [B, n + 1] and as [B, n]; garbage
(entries out of range, one-sided pairs, pairs on edges that do not exist,
a random permutation); no pair at all; and the cold result of a base
batch for a perturbed repeat of it (jittered weights, one edge dropped).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_grid import run_grid  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    ProblemSpec,
    SolveOptions,
    batch,
    graph,
    make_grid,
    plan,
    solve,
)
from repro_torch.core.convert import result_to_numpy  # noqa: E402
from repro_torch.serving.loadgen import perturbed  # noqa: E402
from repro_torch.sparse.csr import batched_row_ptr_from_sorted  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

N = 48
KINDS = ("uniform", "antigreedy", "circuit", "powerlaw")
STATE = ("mate_row", "mate_col", "u", "v")


def _stack(gs):
    return tuple(x.numpy() for x in batch.stack_graphs(gs, device="cpu"))


def _cold(row, col, val):
    st, _ = batch._awpm_batched(*(torch.from_numpy(x) for x in
                                  (row, col, val)), N, backend="torch")
    return st.mate_row.numpy(), st.mate_col.numpy()


def _cases():
    """name -> (row, col, val, mate_row, mate_col): [B, cap] batches of
    n = N and their seeds."""
    rng = np.random.default_rng(19)
    base = [graph.generate(N, avg_degree=5.0, kind=k, seed=30 + i)
            for i, k in enumerate(KINDS)]
    row, col, val = _stack(base)
    mr, mc = _cold(row, col, val)
    out = {"fixed": (row, col, val, mr, mc),
           "fixed_n": (row, col, val, mr[:, :N], mc[:, :N])}
    g_mr, g_mc = mr.copy(), mc.copy()
    g_mr[0, :3] = [-1, N + 7, 2**30]  # out of range
    g_mc[1, g_mr[1, 5]] = (5 + 1) % N  # one-sided: row no longer agrees
    g_mc[1, g_mr[1, 9]] = -4
    j1, j2 = 2, 11  # swapped mates: mutual, but likely on missing edges
    i1, i2 = g_mr[2, j1], g_mr[2, j2]
    g_mr[2, [j1, j2]] = [i2, i1]
    g_mc[2, [i1, i2]] = [j2, j1]
    perm = rng.permutation(N).astype(np.int32)  # mutual, random pairs
    g_mr[3, :N] = perm
    g_mc[3, perm] = np.arange(N, dtype=np.int32)
    out["garbage"] = (row, col, val, g_mr, g_mc)
    none = np.full_like(mr, N)
    out["empty"] = (row, col, val, none, none.copy())
    rep = [perturbed(g, rng, 0.02, 1.0) for g in base]
    out["perturbed"] = (*_stack(rep), mr, mc)
    return out


CASES = _cases()
FLAT = {f"{c}__{k}": x for c, arrs in CASES.items()
        for k, x in zip(("row", "col", "val", "mr", "mc"), arrs)}

REFERENCE = """
import jax.numpy as jnp
from repro.core import batch as B
from repro.core import dist as D
from repro.core.api import MatchingProblem, ProblemSpec, SolveOptions, plan, solve
from repro.sparse.csr import batched_row_ptr_from_sorted

def arrs(c):
    return [IN[f"{c}__{k}"] for k in ("row", "col", "val", "mr", "mc")]

for c in CASES:
    row, col, val, mr, mc = arrs(c)
    jr, jc, jv = jnp.asarray(row), jnp.asarray(col), jnp.asarray(val)
    st, it = B._awpm_batched_from_state(jr, jc, jv, N, mr, mc)
    for k, x in zip(STATE + ("iters",), (*st, it)):
        OUT[f"{c}__engine__{k}"] = x
    ws = B._resolve_window_steps_batched(jr, N, None)
    rp = batched_row_ptr_from_sorted(jr, N)
    nmr, nmc = B._normalize_mates_batched(mr, mc, row.shape[0], N)
    OUT[f"{c}__repair__mr"], OUT[f"{c}__repair__mc"] = \\
        B.repair_mates_batched(jr, jc, jv, rp, N, nmr, nmc, ws)
    OUT[f"{c}__topup__mr"], OUT[f"{c}__topup__mc"] = \\
        B.warm_mates_batched(jr, jc, jv, rp, N, nmr, nmc, ws)
    p = MatchingProblem(row=jr, col=jc, val=jv, n=N)
    r = solve(p, warm_start=(mr, mc))
    for k in RESULT:
        OUT[f"{c}__solve__{k}"] = getattr(r, k)
    r = plan(ProblemSpec(n=N, cap=p.cap, batch=p.batch_size))(
        p, warm_start=(mr, mc))
    for k in RESULT:
        OUT[f"{c}__matcher__{k}"] = getattr(r, k)
    # one instance, lifted to B = 1 inside solve(); seeds [n] and [n + 1]
    p1 = MatchingProblem(row=jr[1], col=jc[1], val=jv[1], n=N)
    for shape, w in (("n1", (mr[1], mc[1])), ("n", (mr[1, :N], mc[1, :N]))):
        r = solve(p1, warm_start=w)
        for k in RESULT:
            OUT[f"{c}__single_{shape}__{k}"] = getattr(r, k)

grid = D.make_mesh((2, 2))
for c in GRID_CASES:
    row, col, val, mr, mc = arrs(c)
    p = MatchingProblem(row=jnp.asarray(row), col=jnp.asarray(col),
                        val=jnp.asarray(val), n=N)
    r = solve(p, SolveOptions(grid=grid), warm_start=(mr, mc))
    for k in RESULT:
        OUT[f"{c}__grid__{k}"] = getattr(r, k)
"""

RESULT = ("mate_row", "mate_col", "weight", "awac_iters", "perfect")
GRID_CASES = ("garbage", "perturbed")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX results, the port's 2x2 gloo grid results per case)."""
    base = tmp_path_factory.mktemp("warm")
    header = (f"N = {N}\nCASES = {list(CASES)!r}\nSTATE = {STATE!r}\n"
              f"RESULT = {RESULT!r}\nGRID_CASES = {GRID_CASES!r}\n")
    jax_out, failed = {}, []

    def reference():
        try:
            (base / "jax").mkdir()
            jax_out.update(run_reference(header + REFERENCE, FLAT,
                                         base / "jax", n_devices=4))
        except Exception as e:  # raised below, in the test's thread
            failed.append(e)

    child = threading.Thread(target=reference)
    child.start()
    try:
        jobs = [(c, "solve", dict(row=CASES[c][0], col=CASES[c][1],
                                  val=CASES[c][2], n=N,
                                  warm=(CASES[c][3], CASES[c][4])))
                for c in GRID_CASES]
        grid = run_grid(2, 2, jobs, base / "grid")
    finally:
        child.join()
    if failed:
        raise failed[0]
    return jax_out, grid


def _tensors(case):
    row, col, val, mr, mc = CASES[case]
    return (*(torch.from_numpy(x) for x in (row, col, val)), mr, mc)


def _assert_result(got, jax, prefix, what):
    """A port result (numpy fields) against JAX's ``prefix`` keys."""
    for k in RESULT:
        want = jax[prefix + k]
        if k == "weight":
            np.testing.assert_allclose(got[k], want, rtol=1e-6,
                                       err_msg=f"{what}: weight")
        else:
            np.testing.assert_array_equal(got[k], want,
                                          err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_warm_engine_matches_jax(runs, case):
    jax = runs[0]
    row, col, val, mr, mc = _tensors(case)
    st, iters = batch._awpm_batched_from_state(row, col, val, N, mr, mc,
                                               backend="torch")
    for k, x in zip(STATE + ("iters",), (*st, iters)):
        want = jax[f"{case}__engine__{k}"]
        assert x.numpy().dtype == want.dtype, (case, k)
        np.testing.assert_array_equal(x.numpy(), want, err_msg=f"{case}: {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_repair_and_top_up_match_jax(runs, case):
    jax = runs[0]
    row, col, val, mr, mc = _tensors(case)
    ws = batch._resolve_window_steps_batched(row, N, None)
    rp = batched_row_ptr_from_sorted(row, N)
    nmr, nmc = batch._normalize_mates_batched(mr, mc, row.shape[0], N, "cpu")
    got = batch.repair_mates_batched(row, col, val, rp, N, nmr, nmc, ws)
    for x, k in zip(got, ("mr", "mc")):
        np.testing.assert_array_equal(x.numpy(), jax[f"{case}__repair__{k}"])
    # the repair leaves a matching on existing edges
    rep_mr = got[0].numpy()
    for b in range(row.shape[0]):
        edges = set(zip(row[b].tolist(), col[b].tolist()))
        for j, i in enumerate(rep_mr[b, :N]):
            assert i == N or (int(i), j) in edges, (case, b, j)
    got = batch.warm_mates_batched(row, col, val, rp, N, nmr, nmc, ws)
    for x, k in zip(got, ("mr", "mc")):
        np.testing.assert_array_equal(x.numpy(), jax[f"{case}__topup__{k}"])


@pytest.mark.parametrize("case", list(CASES))
def test_solve_and_matcher_warm_match_jax(runs, case):
    jax = runs[0]
    row, col, val, mr, mc = _tensors(case)
    p = MatchingProblem(row=row, col=col, val=val, n=N)
    r = solve(p, warm_start=(mr, mc))
    assert r.execution.warm_started
    _assert_result(result_to_numpy(r), jax, f"{case}__solve__", case)
    m = plan(ProblemSpec(n=N, cap=p.cap, batch=p.batch_size))
    r = m(p, warm_start=(torch.from_numpy(mr), torch.from_numpy(mc)))
    assert r.execution.warm_started
    _assert_result(result_to_numpy(r), jax, f"{case}__matcher__",
                   f"{case} Matcher")
    p1 = MatchingProblem(row=row[1], col=col[1], val=val[1], n=N)
    for shape, w in (("n1", (mr[1], mc[1])), ("n", (mr[1, :N], mc[1, :N]))):
        r = solve(p1, warm_start=w)
        _assert_result(result_to_numpy(r), jax, f"{case}__single_{shape}__",
                       f"{case} single {shape}")


def test_fixed_point_seed_comes_back_bit_identical(runs):
    """The contract of a fixed-point seed: every pair kept, no MCM phase,
    one AWAC round, and the cold state returned unchanged."""
    row, col, val, mr, mc = _tensors("fixed")
    cold, cold_iters = batch._awpm_batched(row, col, val, N, backend="torch")
    assert (cold_iters >= 1).all()
    for seed in ((mr, mc), (mr[:, :N], mc[:, :N])):
        st, iters = batch._awpm_batched_from_state(row, col, val, N, *seed,
                                                   backend="torch")
        assert iters.tolist() == [1] * row.shape[0]
        for a, b in zip(st, cold):
            assert torch.equal(a, b)
    r = solve(MatchingProblem(row=row, col=col, val=val, n=N))
    w = solve(MatchingProblem(row=row, col=col, val=val, n=N), warm_start=r)
    assert torch.equal(w.mate_row, r.mate_row)
    assert torch.equal(w.weight, r.weight)
    assert w.awac_iters.tolist() == [1] * row.shape[0]


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_warm_start_matches_jax(runs, case):
    jax, per_rank = runs
    for r, out in enumerate(per_rank):
        got = out[case]
        assert not (isinstance(got, tuple) and got[0] == "raised"), got
        assert got["warm_started"] and got["execution"] == ("fused",
                                                            "grid-default")
        _assert_result(got, jax, f"{case}__grid__", f"{case} rank {r}")
    # and equal to the local warm solve
    row, col, val, mr, mc = _tensors(case)
    local = result_to_numpy(solve(MatchingProblem(row=row, col=col, val=val,
                                                  n=N), warm_start=(mr, mc)))
    for k in ("mate_row", "mate_col", "awac_iters"):
        np.testing.assert_array_equal(per_rank[0][case][k], local[k])


def test_warm_start_on_the_1x1_grid_and_its_matcher():
    grid = make_grid(1, 1, device="cpu")
    row, col, val, mr, mc = _tensors("perturbed")
    p = MatchingProblem(row=row, col=col, val=val, n=N)
    local = solve(p, warm_start=(mr, mc))
    for r in (solve(p, SolveOptions(grid=grid), warm_start=(mr, mc)),
              plan(p, SolveOptions(grid=grid))(p, warm_start=(mr, mc))):
        assert r.execution.warm_started
        for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
            assert torch.equal(getattr(r, k), getattr(local, k)), k


def test_bad_seeds_raise():
    row, col, val, mr, mc = _tensors("fixed")
    p = MatchingProblem(row=row, col=col, val=val, n=N)
    with pytest.raises(ValueError, match="does not fit the problem"):
        solve(p, warm_start=(mr[:, :N - 1], mc[:, :N - 1]))
    with pytest.raises(ValueError, match="does not fit the problem"):
        solve(p, warm_start=(mr[:2], mc[:2]))  # a seed of another batch
    with pytest.raises(ValueError, match="disagree"):
        solve(p, warm_start=(mr, mc[:, :N]))
    with pytest.raises(TypeError, match="MatchResult or a"):
        solve(p, warm_start=12.5)
    with pytest.raises(TypeError, match="MatchResult or a"):
        solve(p, warm_start=(mr,))
    p1 = MatchingProblem(row=row[0], col=col[0], val=val[0], n=N)
    with pytest.raises(ValueError, match="does not fit the problem"):
        solve(p1, warm_start=(mr, mc))  # a batch seed for one instance
    with pytest.raises(ValueError, match=r"\[B, n\] or \[B, n \+ 1\]"):
        batch._normalize_mates_batched(mr[:, :5], mc[:, :5], 4, N, "cpu")
    with pytest.raises(ValueError, match="disagree"):
        batch._normalize_mates_batched(mr, mc[:, :N], 4, N, "cpu")


def test_normalize_takes_any_int_dtype_and_leaves_the_seed_alone():
    _, _, _, mr, mc = CASES["fixed"]
    for conv in (lambda x: x.astype(np.int64), torch.from_numpy,
                 lambda x: torch.from_numpy(x).to(torch.int16)):
        seed = conv(mr)
        got, _ = batch._normalize_mates_batched(seed, conv(mc), 4, N, "cpu")
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), mr)
    t = torch.from_numpy(mr.copy())
    t[:, N] = 0  # the sentinel slot is pinned on the copy, not on the seed
    got, _ = batch._normalize_mates_batched(t, torch.from_numpy(mc), 4, N,
                                            "cpu")
    assert (got[:, N] == N).all() and (t[:, N] == 0).all()


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: backends 'auto' and 'cuda' run the "
                    "AWAC kernels (CUDA C++ for sm_90a, no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_warm_kernels_match_torch_on_the_card(cuda, case):
    row, col, val, mr, mc = _tensors(case)
    row, col, val = (x.to(cuda) for x in (row, col, val))
    want = batch._awpm_batched_from_state(row, col, val, N, mr, mc,
                                          backend="torch")
    for bk in ("auto", "cuda"):
        got = batch._awpm_batched_from_state(row, col, val, N, mr, mc,
                                             backend=bk)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert torch.equal(a, b), (case, bk)
    p = MatchingProblem(row=row, col=col, val=val, n=N)
    r = solve(p, warm_start=(mr, mc))
    assert r.execution.backend == "cuda_persistent" and r.execution.ran_kernel
    assert torch.equal(r.mate_row, want[0].mate_row)
