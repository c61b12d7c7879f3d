"""The hand-written CUDA kernels against their plain torch versions, on the
card: the AWAC sweep (``awac_sweep``) and the persistent AWAC loop
(``awac_persistent``). Both must be bit-identical to their plain versions
(winners, mates, duals and iteration counts).

Every test here needs a CUDA device and skips without one; the decision is
made inside the ``cuda`` fixture. On the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
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
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.cycle_gain.awac_sweep import (  # noqa: E402
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
                               "embedding_bag": 0, "cycle_gain": 0}
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
