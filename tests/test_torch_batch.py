"""The port's batched engine: every phase against ``repro.core.batch`` on
identical inputs, and every lane against its own single-instance run.

The batch mixes every ``graph.SUITE_KINDS`` family (different nnz per
lane) with an infeasible lane, which ``degrade_infeasible`` must gate out
of AWAC while the other lanes iterate. Mates, duals and iteration counts
are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import batch, graph, single  # noqa: E402
from repro_torch.core.convert import state_from_numpy  # noqa: E402
from repro_torch.sparse.csr import batched_row_ptr_from_sorted  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

N = 96
STATE = ("mate_row", "mate_col", "u", "v")
BACKEND_PAIRS = [("reference", "reference"), ("torch", "xla"),
                 ("cuda", "pallas"), ("cuda_persistent", "pallas_persistent")]


def _graphs():
    gs = [graph.generate(N, avg_degree=4.0 + i, kind=k, seed=30 + i)
          for i, k in enumerate(graph.SUITE_KINDS)]
    # an infeasible lane: rows 0 and 1 reach only column 0
    g = graph.generate(N, avg_degree=5.0, kind="antigreedy", seed=40)
    m = g.nnz
    keep = g.row[:m] >= 2
    gs.append(graph.from_coo(
        np.concatenate([g.row[:m][keep], [0, 1]]),
        np.concatenate([g.col[:m][keep], [0, 0]]),
        np.concatenate([g.val[:m][keep], [0.5, 0.7]]), N))
    return gs


EDGES = batch.stack_graphs(_graphs(), device="cpu")  # [B, cap]
B = EDGES[0].shape[0]

REFERENCE = """
import jax.numpy as jnp
from repro.core import batch, single
from repro.sparse.csr import batched_row_ptr_from_sorted

n = int(IN["n"])
row, col, val = (jnp.asarray(IN[k]) for k in ("row", "col", "val"))
mr, mc = batch.greedy_maximal_batched(row, col, val, n)
OUT["greedy__mate_row"], OUT["greedy__mate_col"] = mr, mc
mr, mc = batch.mcm_batched(row, col, val, n, mr, mc)
OUT["mcm__mate_row"], OUT["mcm__mate_col"] = mr, mc
rp = batched_row_ptr_from_sorted(row, n)
ws = single._resolve_window_steps(row, n, None)
st = batch._state_from_mates_windowed(row, col, val, rp, n, mr, mc, ws)
for k, x in zip(STATE, st):
    OUT["state__" + k] = x
for b in ("reference", "xla", "pallas", "pallas_persistent"):
    s, it = batch.awac_batched(row, col, val, n, st, backend=b,
                               degrade_infeasible=True)
    for k, x in zip(STATE + ("iters",), (*s, it)):
        OUT[f"awac_{b}__{k}"] = x
s, it = batch.awac_batched(row, col, val, n, st, max_iter=1, backend="xla")
for k, x in zip(STATE + ("iters",), (*s, it)):
    OUT[f"cut__{k}"] = x
s, it = batch._awpm_batched(row, col, val, n, backend="xla",
                            degrade_infeasible=True)
for k, x in zip(STATE + ("iters",), (*s, it)):
    OUT[f"awpm__{k}"] = x
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = {k: x.numpy() for k, x in zip(("row", "col", "val"), EDGES)}
    inputs["n"] = np.array(N)
    return run_reference(f"STATE = {STATE!r}\n" + REFERENCE, inputs,
                         tmp_path_factory.mktemp("batch"))


def _eq(ref, what, values, names):
    for k, x in zip(names, values):
        np.testing.assert_array_equal(torch.as_tensor(x).numpy(),
                                      ref[f"{what}__{k}"],
                                      err_msg=f"{what}.{k}")


def _ref_state(ref):
    return state_from_numpy(*(ref["state__" + k] for k in STATE),
                            device="cpu")


def test_greedy_mcm_and_state(ref):
    row, col, val = EDGES
    mr, mc = batch.greedy_maximal_batched(row, col, val, N)
    _eq(ref, "greedy", (mr, mc), STATE[:2])
    mr0 = torch.from_numpy(ref["greedy__mate_row"])
    mc0 = torch.from_numpy(ref["greedy__mate_col"])
    mr, mc = batch.mcm_batched(row, col, val, N, mr0, mc0)
    _eq(ref, "mcm", (mr, mc), STATE[:2])
    rp = batched_row_ptr_from_sorted(row, N)
    ws = single._resolve_window_steps(row, N, None)
    st = batch._state_from_mates_windowed(row, col, val, rp, N, mr, mc, ws)
    _eq(ref, "state", st, STATE)
    _eq(ref, "state", batch.state_from_mates_batched(row, col, val, N, mr, mc),
        STATE)


@pytest.mark.parametrize("port, jax_backend", BACKEND_PAIRS)
def test_awac_batched(ref, port, jax_backend):
    row, col, val = EDGES
    s, it = batch.awac_batched(row, col, val, N, _ref_state(ref),
                               backend=port, degrade_infeasible=True)
    _eq(ref, "awac_" + jax_backend, (*s, it), STATE + ("iters",))
    assert it[-1] == 0 and (it[:-1] > 0).all()


def test_max_iter_cutoff_and_full_pipeline(ref):
    row, col, val = EDGES
    s, it = batch.awac_batched(row, col, val, N, _ref_state(ref), max_iter=1,
                               backend="torch")
    _eq(ref, "cut", (*s, it), STATE + ("iters",))
    s, it = batch._awpm_batched(row, col, val, N, backend="torch",
                                degrade_infeasible=True)
    _eq(ref, "awpm", (*s, it), STATE + ("iters",))


@pytest.mark.parametrize("backend", [p for p, _ in BACKEND_PAIRS])
def test_lanes_match_single_instance_runs(backend):
    row, col, val = EDGES
    s, it = batch._awpm_batched(row, col, val, N, backend=backend,
                                degrade_infeasible=True)
    for b in range(B):
        s1, i1 = single._awpm(row[b], col[b], val[b], N, backend=backend,
                              degrade_infeasible=True)
        assert int(i1) == int(it[b]), f"lane {b}"
        for k, x, y in zip(STATE, s1, s):
            assert torch.equal(x, y[b]), f"lane {b}: {k}"
