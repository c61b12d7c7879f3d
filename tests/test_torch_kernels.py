"""The hand-written CUDA kernels against their plain torch versions, on the
card: the AWAC sweep (``awac_sweep``) and the persistent AWAC loop
(``awac_persistent``). Both must be bit-identical to their plain versions
(winners, mates, duals and iteration counts), on the suite's graphs and on
the shapes the kernels' design has to get right: rows longer than the
one-round-trip search, gains that tie across rows of a column, a padding
tail that is no multiple of a chunk, batches of 1 and 40 with lanes gated
off, n of 1, 2 and 33, instances of padding only or without candidates.

Every test here needs a CUDA device and skips without one; the decision is
made inside the ``cuda`` fixture. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    MatchingProblem,
    SolveOptions,
    batch,
    graph,
    single,
    solve,
)
from repro_torch.kernels import (  # noqa: E402
    backend,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.cycle_gain.awac_sweep import (  # noqa: E402
    SweepScratch,
    awac_sweep_batched,
    awac_sweep_plain,
)
from repro_torch.kernels.cycle_gain.persistent import (  # noqa: E402
    awac_persistent_batched,
    awac_persistent_plain,
)
from repro_torch.sparse.csr import batched_row_ptr_from_sorted  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU mode")
    return torch.device("cuda")


def _batch_state(dev, n, kinds, deg=6.0):
    gs = [graph.generate(n, avg_degree=deg, kind=k, seed=i)
          for i, k in enumerate(kinds)]
    row, col, val = batch.stack_graphs(gs, device=dev)
    mr, mc = batch.greedy_maximal_batched(row, col, val, n)
    mr, mc = batch.mcm_batched(row, col, val, n, mr, mc)
    rp = batched_row_ptr_from_sorted(row, n)
    ws = single._resolve_window_steps(row, n, None)
    st = batch._state_from_mates_windowed(row, col, val, rp, n, mr, mc, ws)
    return (row, col, val, rp, *st), ws


def _prepare(gs, n, dev, start=None):
    """Kernel inputs for the graphs ``gs`` (one n): the edges, row_ptr and
    the state from ``start`` (mates [B, n + 1]) or from the MCM."""
    row, col, val = batch.stack_graphs(gs, device=dev)
    rp = batched_row_ptr_from_sorted(row, n)
    ws = single._resolve_window_steps(row, n, None)
    if start is None:
        mr, mc = batch.greedy_maximal_batched(row, col, val, n)
        mr, mc = batch.mcm_batched(row, col, val, n, mr, mc)
    else:
        mr, mc = (x.to(dev) for x in start)
    st = batch._state_from_mates_windowed(row, col, val, rp, n, mr, mc, ws)
    return (row, col, val, rp, *st), ws


def _coo(n, row, col, val, capacity=None):
    """A graph from COO entries, duplicates of a (row, col) pair dropped."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    _, first = np.unique(row * n + col, return_index=True)
    return graph.from_coo(row[first], col[first],
                          np.asarray(val, np.float32)[first], n,
                          capacity=capacity)


def _long_rows(n, seed):
    """A planted diagonal, rows of 1 + Poisson(6) entries, and one row in
    ten with 33 to 200 entries (past the one-round-trip search)."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) % 10 == 0, rng.integers(33, 201, n),
                   1 + rng.poisson(6, n))
    row = np.concatenate([np.arange(n), np.repeat(np.arange(n), deg)])
    col = np.concatenate([np.arange(n), rng.integers(0, n, deg.sum())])
    val = rng.uniform(0.9, 1.0, row.size)
    val[:n] = rng.uniform(0.5, 0.6, n)
    return _coo(n, row, col, val)


def _ties(n, seed):
    """Weights from {0.25, 0.5, 0.75, 1.0}: gains tie across the rows of a
    column and across the columns of an e2 column."""
    rng = np.random.default_rng(seed)
    m = 6 * n
    row = np.concatenate([np.arange(n), rng.integers(0, n, m)])
    col = np.concatenate([rng.permutation(n), rng.integers(0, n, m)])
    return _coo(n, row, col, rng.integers(1, 5, row.size) * 0.25)


def _tie_blocks(n):
    """Blocks of 4 rows and columns, 0.5 on the diagonal and 0.75 off it,
    with the diagonal matching: every 4-cycle gains exactly 0.5."""
    rows, cols = [], []
    for k in range(0, n - 3, 4):
        for i in range(k, k + 4):
            for j in range(k, k + 4):
                rows.append(i)
                cols.append(j)
    rows += list(range(n - n % 4, n))
    cols += list(range(n - n % 4, n))
    rows, cols = np.array(rows), np.array(cols)
    return _coo(n, rows, cols, np.where(rows == cols, 0.5, 0.75))


def _assert_identical(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"output {i}"


@pytest.mark.parametrize("n", [1000, 20000])
def test_sweep_kernel_matches_plain(cuda, n):
    args, ws = _batch_state(cuda, n, graph.SUITE_KINDS)
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    got = awac_sweep_batched(*args, mg, n=n, window_steps=ws)
    torch.cuda.synchronize()
    want = awac_sweep_plain(*args, mg, n=n, window_steps=ws)
    _assert_identical(got, want)
    assert torch.isfinite(got[0]).any()  # some columns have a candidate


@pytest.mark.parametrize("max_iter", [0, 1, 1000])
def test_persistent_kernel_matches_plain(cuda, max_iter):
    n = 5000
    args, ws = _batch_state(cuda, n, graph.SUITE_KINDS + ("antigreedy",))
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    go0 = torch.tensor([True, True, True, True, False, True], device=cuda)
    got = awac_persistent_batched(*args, mg, go0, n=n, window_steps=ws,
                                  max_iter=max_iter)
    torch.cuda.synchronize()
    want = awac_persistent_plain(*args, mg, go0, n=n, window_steps=ws,
                                 max_iter=max_iter)
    _assert_identical(got, want)
    assert int(got[4][4]) == 0  # gated off by go0
    _assert_identical(tuple(x[4] for x in got[:4]),
                      tuple(x[4] for x in args[4:8]))


def test_solve_goes_through_the_kernels(cuda):
    g = graph.generate(30000, avg_degree=8.0, kind="antigreedy", seed=3)
    p = MatchingProblem.from_graph(g)
    reset_launch_counts()
    auto = solve(p)
    assert auto.execution.backend == "cuda_persistent"
    assert auto.execution.ran_kernel is True
    assert launch_counts() == {"awac_sweep": 0, "awac_persistent": 1,
                               "flash_attention": 0, "router_swap": 0,
                               "embedding_bag": 0, "cycle_gain": 0,
                               "mcm_persistent": 1}
    sweep = solve(p, SolveOptions(backend="cuda"))
    assert launch_counts()["awac_sweep"] == int(sweep.awac_iters) > 0
    plain = solve(p, SolveOptions(backend="torch"))
    for r in (sweep, plain):
        assert torch.equal(r.mate_row, auto.mate_row)
        assert torch.equal(r.mate_col, auto.mate_col)
        assert int(r.awac_iters) == int(auto.awac_iters)


def test_kernel_wrappers_check_their_inputs(cuda):
    args, ws = _batch_state(cuda, 500, ("uniform",))
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    bad = (args[0].long(),) + args[1:]
    with pytest.raises(ValueError, match="row"):
        awac_sweep_batched(*bad, mg, n=500, window_steps=ws)
    with pytest.raises(ValueError, match="go0"):
        awac_persistent_batched(*args, mg, torch.ones(2, dtype=torch.bool,
                                                      device=cuda),
                                n=500, window_steps=ws, max_iter=10)


def _case(name, dev):
    """(kernel inputs, window_steps, n, go0) of a named case."""
    if name == "long_rows":
        n, gs, start = 3000, [_long_rows(3000, s) for s in range(3)], None
    elif name == "ties":
        n, gs, start = 2000, [_ties(2000, s) for s in range(3)], None
    elif name == "tie_blocks":
        n = 4002
        gs = [_tie_blocks(n)] * 2
        diag = torch.arange(n + 1, dtype=torch.int32).repeat(2, 1)
        start = (diag, diag)
    elif name == "ragged_tail":
        # capacities that are no multiple of a chunk or of 8
        n = 1500
        gs = []
        for s, pad in enumerate((37, 1029, 1)):
            g = graph.generate(n, avg_degree=7.0, kind="powerlaw", seed=s)
            m = g.nnz
            gs.append(graph.from_coo(g.row[:m], g.col[:m], g.val[:m], n,
                                     capacity=m + pad))
        start = None
    elif name == "edge_instances":
        # padding only, no candidates (the diagonal alone), and a real one
        n = 700
        empty = np.zeros(0, np.int64)
        rng = np.random.default_rng(5)
        gs = [_coo(n, empty, empty, empty, capacity=64),
              _coo(n, np.arange(n), np.arange(n), rng.uniform(0.1, 1.0, n)),
              graph.generate(n, avg_degree=6.0, kind="antigreedy", seed=2)]
        start = None
    else:
        raise ValueError(name)
    args, ws = _prepare(gs, n, dev, start)
    return args, ws, n, torch.ones(len(gs), dtype=torch.bool, device=dev)


CASE_NAMES = ("long_rows", "ties", "tie_blocks", "ragged_tail",
              "edge_instances")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_kernels_match_plain_on_design_cases(cuda, name):
    args, ws, n, go = _case(name, cuda)
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    got = awac_sweep_batched(*args, mg, n=n, window_steps=ws)
    torch.cuda.synchronize()
    _assert_identical(got, awac_sweep_plain(*args, mg, n=n, window_steps=ws))
    if name in ("long_rows", "ties", "tie_blocks"):
        assert torch.isfinite(got[0]).any()  # the case has candidates
    for max_iter in (0, 1, 1000):
        got = awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                      max_iter=max_iter)
        torch.cuda.synchronize()
        _assert_identical(got, awac_persistent_plain(
            *args, mg, go, n=n, window_steps=ws, max_iter=max_iter))


def test_long_rows_case_reaches_past_the_short_search(cuda):
    """The long-row case looks rows of more than 32 entries up."""
    args, _, n, _ = _case("long_rows", cuda)
    row, col, rp, mr = args[0], args[1], args[3], args[4]
    qr = torch.gather(mr, 1, col.long().clamp(0, n)).long()
    look = (row < n) & (qr < n) & (row > qr)
    q = qr.clamp(0, n - 1)
    length = torch.gather(rp, 1, q + 1) - torch.gather(rp, 1, q)
    assert bool((look & (length > 32)).any())
    assert bool((look & (length <= 20)).any())


@pytest.mark.parametrize("b", [1, 40])
def test_kernels_match_plain_with_gated_lanes(cuda, b):
    n = 2500
    kinds = graph.SUITE_KINDS
    gs = [graph.generate(n, avg_degree=6.0, kind=kinds[i % len(kinds)],
                         seed=i) for i in range(b)]
    args, ws = _prepare(gs, n, cuda)
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    go0 = torch.arange(b, device=cuda) % 3 != 1
    if b == 1:
        go0[0] = True
    got = awac_sweep_batched(*args, mg, n=n, window_steps=ws)
    torch.cuda.synchronize()
    _assert_identical(got, awac_sweep_plain(*args, mg, n=n, window_steps=ws))
    got = awac_persistent_batched(*args, mg, go0, n=n, window_steps=ws,
                                  max_iter=1000)
    torch.cuda.synchronize()
    want = awac_persistent_plain(*args, mg, go0, n=n, window_steps=ws,
                                 max_iter=1000)
    _assert_identical(got, want)
    assert bool((got[4][~go0] == 0).all())  # gated lanes run no round
    assert bool((got[4][go0] > 0).all())


@pytest.mark.parametrize("name", CASE_NAMES)
def test_sweep_scratch_carries_over_rounds(cuda, name):
    """One scratch through every round of the loop, as the engines pass
    it: the first call builds the row records, the later ones reuse them
    and find the keys the previous call left zero; a call on other edges
    builds them again."""
    args, ws, n, go = _case(name, cuda)
    b = args[0].shape[0]
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    scratch = SweepScratch()
    rounds = int(awac_persistent_plain(*args, mg, go, n=n, window_steps=ws,
                                       max_iter=1000)[4].max())
    for r in range(rounds + 1):
        st = args[4:8] if r == 0 else awac_persistent_plain(
            *args, mg, go, n=n, window_steps=ws, max_iter=r)[:4]
        cur = args[:4] + tuple(st)
        got = awac_sweep_batched(*cur, mg, n=n, window_steps=ws,
                                 scratch=scratch)
        torch.cuda.synchronize()
        _assert_identical(got, awac_sweep_plain(*cur, mg, n=n,
                                                window_steps=ws))
        assert bool((scratch.buf[2 * b * n:] == 0).all())  # keys left zero
    other, ws2, n2, _ = _case("ragged_tail" if name != "ragged_tail"
                              else "ties", cuda)
    got = awac_sweep_batched(*other, mg, n=n2, window_steps=ws2,
                             scratch=scratch)
    torch.cuda.synchronize()
    _assert_identical(got, awac_sweep_plain(*other, mg, n=n2,
                                            window_steps=ws2))


def test_persistent_kernel_sets_its_scratch(cuda):
    """K2's scratch comes from ``torch.empty``: memory that held anything
    (here, all ones bits) must not change the result."""
    args, ws, n, go = _case("long_rows", cuda)
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    want = awac_persistent_plain(*args, mg, go, n=n, window_steps=ws,
                                 max_iter=1000)
    words = (backend.library().awac_persistent_scratch_bytes(
        args[0].shape[0], n) + 7) // 8
    for _ in range(2):
        # blocks of the scratch's size, back to the caching allocator with
        # their bits kept: the wrapper's outputs take one, its scratch the
        # other
        junk = [torch.full((words,), -1, dtype=torch.int64, device=cuda)
                for _ in range(2)]
        del junk
        got = awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                      max_iter=1000)
        torch.cuda.synchronize()
        _assert_identical(got, want)


@pytest.mark.parametrize("n", [1, 2, 33])
def test_kernels_match_plain_at_tiny_n(cuda, n):
    if n == 1:
        gs = [_coo(1, [0], [0], [0.5])] * 2
    elif n == 2:
        # from the diagonal matching, the 4-cycle gains 0.8
        gs = [_coo(2, [0, 0, 1, 1], [0, 1, 0, 1], [0.5, 0.9, 0.9, 0.5]),
              _coo(2, [0, 1], [0, 1], [0.5, 0.5])]
    else:
        gs = [graph.generate(33, avg_degree=5.0, kind=k, seed=i)
              for i, k in enumerate(graph.SUITE_KINDS)]
    diag = torch.arange(n + 1, dtype=torch.int32).repeat(len(gs), 1)
    args, ws = _prepare(gs, n, cuda, (diag, diag) if n < 33 else None)
    mg = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    got = awac_sweep_batched(*args, mg, n=n, window_steps=ws)
    torch.cuda.synchronize()
    _assert_identical(got, awac_sweep_plain(*args, mg, n=n, window_steps=ws))
    go = torch.ones(len(gs), dtype=torch.bool, device=cuda)
    for max_iter in (0, 1, 1000):
        got = awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                      max_iter=max_iter)
        torch.cuda.synchronize()
        _assert_identical(got, awac_persistent_plain(
            *args, mg, go, n=n, window_steps=ws, max_iter=max_iter))
    if n == 2:
        assert int(got[4][0]) >= 1 and int(got[0][0, 0]) == 1  # swapped
