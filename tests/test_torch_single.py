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
    against the Pallas kernels' wrappers;
  - the sweep re-derived the way the CUDA kernels reduce it (one 64-bit
    key per column, its low word the winning edge's position) against the
    Pallas sweep, and the property that derivation rests on.

Mates, duals, winners and iteration counts are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph, single  # noqa: E402
from repro_torch.core.convert import state_from_numpy  # noqa: E402
from repro_torch.kernels.cycle_gain.awac_sweep import (  # noqa: E402
    SweepScratch,
    awac_sweep_batched,
)
from repro_torch.kernels.cycle_gain.ops import (  # noqa: E402
    awac_persistent_loop,
    awac_sweep_winners,
)
from repro_torch.kernels.cycle_gain.persistent import (  # noqa: E402
    awac_persistent_batched,
)
from repro_torch.sparse.csr import row_ptr_from_sorted  # noqa: E402
from repro_torch.sparse.ops import NEG  # noqa: E402
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


def _position_key_sweep(row, col, val, n, mate_row, mate_col, u, v,
                        min_gain):
    """Steps A+B+C as the CUDA kernels reduce them, in plain torch: per
    candidate edge at position pos the key (gain key << 32) | ~pos, with
    the gain mapped to an order-preserving uint32; the largest key per
    column (reduced as int64 with the top bit flipped, so that a signed
    max orders it as unsigned); then the winner's row and w1 read at pos
    and w2 looked up again for the winner alone. Returns (Cgain, Ci, Cw1,
    Cw2) with the engines' sentinels."""
    cap = row.numel()
    r, c = row.long(), col.long()
    pos = torch.arange(cap)
    edge = (r >= 0) & (r < n) & (c >= 0) & (c < n)
    # the completion edge (m_j, m_i) of every edge, by its (row, col) key
    keys = r * (n + 1) + c

    def lookup(i, j):
        want = i * (n + 1) + j
        at = torch.searchsorted(keys, want).clamp(max=cap - 1)
        return keys[at] == want, at

    qr = mate_row.long()[c.clamp(0, n)]
    m_i = mate_col.long()[r.clamp(0, n)]
    shape = edge & (qr >= 0) & (qr < n) & (r > qr)
    found, at = lookup(qr.clamp(0, n), m_i)
    w2 = torch.where(found, val[at], 0.0)
    gain = ((val + w2) - u[r.clamp(0, n)]) - v[c.clamp(0, n)]
    cand = shape & found & (gain > min_gain)
    bits = gain.view(torch.int32).long() & 0xFFFFFFFF
    gkey = torch.where(bits >= 2**31, ~bits & 0xFFFFFFFF, bits ^ 2**31)
    low = ~pos & 0xFFFFFFFF
    # (gkey << 32 | low) with bit 63 flipped, as a signed int64
    skey = ((gkey ^ 2**31) - 2**31) * 2**32 + low
    empty = -2**63  # key 0
    best = torch.full((n,), empty, dtype=torch.int64).scatter_reduce(
        0, c.clamp(0, n - 1)[cand], skey[cand], reduce="amax")
    has = best != empty
    hi = (best >> 32) + 2**31  # the high word, unflipped back below
    gk = hi ^ 2**31
    gbits = torch.where(gk >= 2**31, gk ^ 2**31, ~gk & 0xFFFFFFFF)
    cgain = torch.where(has, (gbits - (gbits >= 2**31).long() * 2**32)
                        .to(torch.int32).view(torch.float32), NEG)
    win = torch.where(has, 0xFFFFFFFF - (best & 0xFFFFFFFF), 0)
    ci = torch.where(has, r[win], n).to(torch.int32)
    cw1 = torch.where(has, val[win], 0.0)
    j = torch.arange(n)
    f2, at2 = lookup(mate_row.long()[j], mate_col.long()[r[win].clamp(0, n)])
    assert bool((f2 | ~has).all())  # every winner's completion edge exists
    cw2 = torch.where(has, val[at2], 0.0)
    return cgain, ci, cw1, cw2


@pytest.mark.parametrize("name", list(CASES))
def test_position_key_sweep_matches_pallas(ref, name):
    row, col, val = _edges(name)
    st = _state(ref, name, "start")
    win = _position_key_sweep(row, col, val, N, *st,
                              torch.tensor(1e-6, dtype=torch.float32))
    _assert_equal(ref, name, "sweep", win, WINNERS)


@pytest.mark.parametrize("name", list(CASES))
def test_edge_position_grows_with_row_in_each_column(name):
    """The kernels' winner key carries the edge's position in place of
    its row: that picks the same winner on a gain tie only if, inside
    each column, the position grows with the row (lex-sorted edges with
    unique (row, col) pairs)."""
    row, col, _ = _edges(name)
    real = (row < N).nonzero().flatten()
    order = torch.sort(col[real], stable=True).indices
    c, r = col[real][order], row[real][order]
    same_col = c[1:] == c[:-1]
    assert bool((r[1:][same_col] > r[:-1][same_col]).all())


@pytest.mark.parametrize("entry", ["sweep", "loop"])
def test_kernel_wrappers_refuse_positions_past_int32(entry):
    """An instance's edge positions must fit the low 32 bits of a winner
    key: both kernel wrappers refuse cap >= 2**31 on any device (meta
    tensors here, so nothing is allocated)."""
    n, cap = 4, 2**31
    meta = dict(device="meta")
    edges = (torch.empty((1, cap), dtype=torch.int32, **meta),
             torch.empty((1, cap), dtype=torch.int32, **meta),
             torch.empty((1, cap), dtype=torch.float32, **meta),
             torch.empty((1, n + 2), dtype=torch.int32, **meta))
    state = (torch.empty((1, n + 1), dtype=torch.int32, **meta),
             torch.empty((1, n + 1), dtype=torch.int32, **meta),
             torch.empty((1, n + 1), dtype=torch.float32, **meta),
             torch.empty((1, n + 1), dtype=torch.float32, **meta))
    mg = torch.tensor(1e-6, dtype=torch.float32)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        if entry == "sweep":
            awac_sweep_batched(*edges, *state, mg, n=n, window_steps=3)
        else:
            awac_persistent_batched(*edges, *state, mg,
                                    torch.ones(1, dtype=torch.bool, **meta),
                                    n=n, window_steps=3, max_iter=10)


@pytest.mark.parametrize("change", ["none", "view", "col_written",
                                    "rp_written", "other_col", "unbuilt",
                                    "other_size"])
def test_sweep_scratch_is_rebuilt_only_for_other_edges(change):
    """The sweep kernel's scratch keeps its row records from one call to
    the next only while the edges are the same: the same memory, shape and
    strides, not written since (a [1, ...] view of them, as the
    single-instance entry passes each round, counts as the same), and the
    last call marked it built. The scratch logic is device-free, so it is
    held here on CPU tensors."""
    row, col, _ = _edges("uniform")
    col, rp = col[None].clone(), row_ptr_from_sorted(row, N)[None].clone()
    words = 3 * N
    s = SweepScratch()
    buf, build, tags = s.take(col, rp, words)
    assert build and buf.numel() == words
    s.built(col, rp, tags)
    col2, rp2 = col, rp
    if change == "view":
        col2, rp2 = col[0][None], rp[0][None]
    elif change == "col_written":
        col.add_(0)
    elif change == "rp_written":
        rp.add_(0)
    elif change == "other_col":
        col2 = col.clone()
    elif change == "unbuilt":
        s.take(col, rp, words)  # a call that failed before ``built``
    elif change == "other_size":
        words += 3
    again, build, _ = s.take(col2, rp2, words)
    assert build == (change not in ("none", "view"))
    assert (again is buf) == (change != "other_size")
