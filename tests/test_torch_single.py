"""The port's single-instance engine against the JAX package, on the CPU.

For every ``graph.SUITE_KINDS`` family and the edge cases (gain ties, an
all-padding instance, no candidates, ``max_iter=0``, an infeasible
instance under ``degrade_infeasible``), on identical inputs:

  - greedy, MCM and one ``select_and_augment`` round against JAX;
  - AWAC from the JAX MCM state (or a given start state) on the port's
    ``reference`` / ``torch`` backends against JAX ``reference`` / ``xla``,
    and the plain versions
    of the two kernels (backends ``cuda`` / ``cuda_persistent`` on a CPU
    tensor) against JAX ``pallas`` / ``pallas_persistent`` (interpreted);
  - the sweep alone (K1's plain version) and the whole loop alone (K2's)
    against the Pallas kernels' wrappers.

Mates, duals, winners and iteration counts are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph, single  # noqa: E402
from repro_torch.core.convert import state_from_numpy  # noqa: E402
from repro_torch.kernels.cycle_gain.ops import (  # noqa: E402
    awac_persistent_loop,
    awac_sweep_winners,
)
from repro_torch.sparse.csr import row_ptr_from_sorted  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

N = 120
CAP = 1024
STATE = ("mate_row", "mate_col", "u", "v")
WINNERS = ("Cgain", "Ci", "Cw1", "Cw2")
# port backend -> JAX backend it answers to
BACKEND_PAIRS = [("reference", "reference"), ("torch", "xla"),
                 ("cuda", "pallas"), ("cuda_persistent", "pallas_persistent")]


def _padded(row, col, val):
    return graph.from_coo(row, col, val, N, capacity=CAP)


def _from_generated(kind, deg, seed):
    g = graph.generate(N, avg_degree=deg, kind=kind, seed=seed)
    m = g.nnz
    return _padded(g.row[:m], g.col[:m], g.val[:m])


def _tie_blocks():
    """Blocks of 4 rows/cols with weight 0.5 on the diagonal and 0.75 off
    it, started from the diagonal matching: every 4-cycle gains exactly
    0.5. In a "clique" block a column has several candidate rows of equal
    gain (Step C tie); in a "star" block one row wins two columns of equal
    gain, which then meet in one e2 column (Step D tie)."""
    rows, cols = [np.arange(N)], [np.arange(N)]
    vals = [np.full(N, 0.5)]
    for k in range(0, N, 4):
        if (k // 4) % 2 == 0:
            pairs = [(i, j) for i in range(k, k + 4) for j in range(k, k + 4)
                     if i != j]
        else:
            pairs = [(k + 3, k), (k, k + 3), (k + 3, k + 1), (k + 1, k + 3)]
        rows.append(np.array([i for i, _ in pairs]))
        cols.append(np.array([j for _, j in pairs]))
        vals.append(np.full(len(pairs), 0.75))
    g = _padded(np.concatenate(rows).astype(np.int32),
                np.concatenate(cols).astype(np.int32),
                np.concatenate(vals).astype(np.float32))
    diag = np.arange(N, dtype=np.int32)
    return g, (diag, diag)


def _cases():
    """name -> (graph, max_iter, degrade_infeasible, start mates or None
    for the MCM state)."""
    cases = {}
    for i, kind in enumerate(graph.SUITE_KINDS):
        cases[kind] = (_from_generated(kind, 4.0 + i, 10 + i), 1000, False,
                       None)
    g, start = _tie_blocks()
    cases["gain_ties"] = (g, 1000, False, start)
    empty = np.zeros(0, np.int32)
    cases["all_padding"] = (_padded(empty, empty, np.zeros(0, np.float32)),
                            1000, True, None)
    rng = np.random.default_rng(5)
    diag = np.arange(N, dtype=np.int32)
    cases["no_candidates"] = (_padded(diag, diag, rng.uniform(
        0.1, 1.0, N).astype(np.float32)), 1000, False, None)
    cases["max_iter_0"] = (_from_generated("antigreedy", 6.0, 21), 0, False,
                           None)
    # rows 0 and 1 reach only column 0: a Hall violation with no empty row
    g = graph.generate(N, avg_degree=5.0, kind="uniform", seed=8)
    m = g.nnz
    keep = g.row[:m] >= 2
    row = np.concatenate([g.row[:m][keep], [0, 1]]).astype(np.int32)
    col = np.concatenate([g.col[:m][keep], [0, 0]]).astype(np.int32)
    val = np.concatenate([g.val[:m][keep], [0.5, 0.7]]).astype(np.float32)
    cases["infeasible"] = (_padded(row, col, val), 1000, True, None)
    return cases


CASES = _cases()

REFERENCE = """
import jax.numpy as jnp
from repro.core import single
from repro.kernels.cycle_gain.ops import awac_persistent_loop, awac_sweep_winners
from repro.sparse.csr import row_ptr_from_sorted

n = int(IN["n"])
mg = jnp.float32(1e-6)
for nm in [str(x) for x in IN["names"]]:
    row, col, val = (jnp.asarray(IN[f"{nm}__{k}"]) for k in ("row", "col", "val"))
    max_iter = int(IN[f"{nm}__max_iter"])
    degrade = bool(IN[f"{nm}__degrade"])

    def put(what, values, names):
        for k, x in zip(names, values):
            OUT[f"{nm}__{what}__{k}"] = np.asarray(x)

    st = single.greedy_maximal(row, col, val, n)
    put("greedy", st, STATE)
    st = single.mcm(row, col, val, n, st.mate_row, st.mate_col)
    put("mcm", st, STATE)
    if f"{nm}__start_mr" in IN:
        st = single.state_from_mates(row, col, val, n, IN[f"{nm}__start_mr"],
                                     IN[f"{nm}__start_mc"])
    put("start", st, STATE)
    win = single.awac_cwinners(row, col, val, n, st, mg)
    put("winners", win, WINNERS)
    st1, n_surv = single.select_and_augment(n, *win, st, mg)
    put("select", (*st1, n_surv), STATE + ("n_surv",))
    for b in ("reference", "xla", "pallas", "pallas_persistent"):
        s, it = single.awac(row, col, val, n, st, max_iter=max_iter,
                            backend=b, degrade_infeasible=degrade)
        put("awac_" + b, (*s, it), STATE + ("iters",))
    rp = row_ptr_from_sorted(row, n)
    ws = single._resolve_window_steps(row, n, None)
    put("sweep", awac_sweep_winners(row, col, val, rp, *st, mg, n=n,
                                    window_steps=ws), WINNERS)
    go0 = single.is_perfect(st, n) if degrade else jnp.array(True)
    put("loop", awac_persistent_loop(row, col, val, rp, *st, mg, go0, n=n,
                                     window_steps=ws, max_iter=max_iter),
        STATE + ("iters",))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {"n": np.array(N), "names": np.array(list(CASES))}
    for nm, (g, max_iter, degrade, start) in CASES.items():
        inputs.update({f"{nm}__row": g.row, f"{nm}__col": g.col,
                       f"{nm}__val": g.val, f"{nm}__max_iter": np.array(max_iter),
                       f"{nm}__degrade": np.array(degrade)})
        if start is not None:
            inputs[f"{nm}__start_mr"], inputs[f"{nm}__start_mc"] = start
    body = f"STATE = {STATE!r}\nWINNERS = {WINNERS!r}\n" + REFERENCE
    return run_reference(body, inputs, tmp_path_factory.mktemp("single"))


def _edges(name):
    g = CASES[name][0]
    return tuple(torch.from_numpy(x) for x in (g.row, g.col, g.val))


def _state(ref, name, what):
    return state_from_numpy(*(ref[f"{name}__{what}__{k}"] for k in STATE),
                            device="cpu")


def _assert_equal(ref, name, what, values, names):
    for k, x in zip(names, values):
        np.testing.assert_array_equal(
            torch.as_tensor(x).numpy(), ref[f"{name}__{what}__{k}"],
            err_msg=f"{name}: {what}.{k}")


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_and_mcm(ref, name):
    row, col, val = _edges(name)
    st = single.greedy_maximal(row, col, val, N)
    _assert_equal(ref, name, "greedy", st, STATE)
    # MCM from the JAX greedy state, so a fault shows in its own phase
    g0 = _state(ref, name, "greedy")
    st = single.mcm(row, col, val, N, g0.mate_row, g0.mate_col)
    _assert_equal(ref, name, "mcm", st, STATE)


@pytest.mark.parametrize("name", list(CASES))
def test_winners_and_select_and_augment(ref, name):
    row, col, val = _edges(name)
    start = CASES[name][3]
    if start is not None:  # the port builds the start state itself
        st = single.state_from_mates(row, col, val, N, *map(torch.from_numpy,
                                                           start))
        _assert_equal(ref, name, "start", st, STATE)
    st = _state(ref, name, "start")
    mg = torch.tensor(1e-6, dtype=torch.float32)
    win = single.awac_cwinners(row, col, val, N, st, mg)
    _assert_equal(ref, name, "winners", win, WINNERS)
    rp = row_ptr_from_sorted(row, N)
    ws = single._resolve_window_steps(row, N, None)
    fused = single.awac_cwinners_fused(row, col, val, rp, N, st, mg, ws)
    _assert_equal(ref, name, "winners", fused, WINNERS)
    st1, n_surv = single.select_and_augment(N, *win, st)
    _assert_equal(ref, name, "select", (*st1, n_surv), STATE + ("n_surv",))


@pytest.mark.parametrize("port, jax_backend", BACKEND_PAIRS)
@pytest.mark.parametrize("name", list(CASES))
def test_awac_backends(ref, name, port, jax_backend):
    row, col, val = _edges(name)
    _, max_iter, degrade, _ = CASES[name]
    st, it = single.awac(row, col, val, N, _state(ref, name, "start"),
                         max_iter=max_iter, backend=port,
                         degrade_infeasible=degrade)
    _assert_equal(ref, name, "awac_" + jax_backend, (*st, it),
                  STATE + ("iters",))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_plain_versions_match_pallas(ref, name):
    row, col, val = _edges(name)
    _, max_iter, degrade, _ = CASES[name]
    st = _state(ref, name, "start")
    rp = row_ptr_from_sorted(row, N)
    ws = single._resolve_window_steps(row, N, None)
    mg = torch.tensor(1e-6, dtype=torch.float32)
    win = awac_sweep_winners(row, col, val, rp, *st, mg, n=N, window_steps=ws)
    _assert_equal(ref, name, "sweep", win, WINNERS)
    go0 = single.is_perfect(st, N) if degrade else torch.tensor(True)
    out = awac_persistent_loop(row, col, val, rp, *st, mg, go0, n=N,
                               window_steps=ws, max_iter=max_iter)
    _assert_equal(ref, name, "loop", out, STATE + ("iters",))


def test_cases_exercise_what_they_name(ref):
    iters = {nm: int(ref[f"{nm}__awac_reference__iters"]) for nm in CASES}
    assert iters["antigreedy"] > 1
    assert iters["max_iter_0"] == 0
    assert iters["infeasible"] == 0  # degrade_infeasible skips the loop
    assert not bool((ref["infeasible__mcm__mate_row"][:N] < N).all())
    assert iters["no_candidates"] == 1
    assert not np.isfinite(ref["no_candidates__winners__Cgain"]).any()
    assert (ref["all_padding__mcm__mate_row"] == N).all()
    # gain_ties: clique blocks tie in Step C (the smaller row wins), star
    # blocks tie in Step D (the smaller column survives)
    ci = ref["gain_ties__winners__Ci"]
    assert (ci[0:4] == [1, 2, 3, N]).all()
    assert (ci[4:8] == [7, 7, N, N]).all()
    sel = ref["gain_ties__select__mate_row"]
    assert sel[4] == 7 and sel[5] == 5  # column 4 won the e2 column 7
    assert iters["gain_ties"] > 1
